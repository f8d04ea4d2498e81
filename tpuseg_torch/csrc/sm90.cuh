// Shared by the kernel sources: cp.async and bulk-copy staging, and the
// exact-fp32 products on the tensor cores.
//
// 3xTF32. Each fp32 operand v is split into big = tf32(v), rounded to
// nearest, and a small rest; a product a*b is then accumulated as
// small_a*big_b + big_a*small_b + big_a*big_b with mma.sync m16n8k8 tf32
// (fp32 accumulate). The dropped small*small term is about 2^-22 of |ab|.
// The tensor core's own fp32 sums truncate toward zero, so the kernels
// chain only a few k-steps on it, from zero, and add each short sum into a
// running sum in round-to-nearest fp32 on the CUDA cores.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16- or 4-byte global -> shared copy; zero-fills the destination when !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Bulk copies (the TMA unit): one instruction moves a whole contiguous
// span (16-byte aligned at both ends, a multiple of 16 bytes long) into
// shared memory and signals an mbarrier with its byte count. Unlike
// cp.async, whose 16-byte requests each hold a slot of the SM's few
// outstanding loads, a span of any length is one request.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive once on bar and expect `bytes` more of bulk copies in this phase
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait for the phase of bar with this parity to complete
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// v = big + small: big = tf32(v), rounded to nearest; small = v - big is
// exact in fp32 and goes to the tensor core as it is, which reads its top
// 19 bits (a TF32 truncation: 2^-21 of v at most, with no bias, as small's
// sign is independent of v's)
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(v));
  small = __float_as_uint(v - __uint_as_float(big));
}

// as split_tf32, with small rounded to nearest TF32 too (2^-22 of v at
// most) instead of truncated by the tensor core. Both roundings are done as
// cvt.rna does them (to nearest, ties away from zero) but by integer adds
// and masks on the full-rate pipe.
__device__ __forceinline__ uint32_t tf32_rna(uint32_t u) { return (u + 0x1000u) & 0xffffe000u; }

__device__ __forceinline__ void split_tf32_rn(float v, uint32_t& big, uint32_t& small) {
  big = tf32_rna(__float_as_uint(v));
  small = tf32_rna(__float_as_uint(v - __uint_as_float(big)));
}

// d += a (16x8, row) * b (8x8, col), tf32 in, fp32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// as mma_tf32, but not volatile: the compiler may schedule independent
// products around each other
__device__ __forceinline__ void mma_tf32_unordered(float (&d)[4], const uint32_t (&a)[4],
                                                   uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
