// argmax over classes of the exact x2 align_corners=True bilinear upsample,
// without the full-resolution logits ever existing.
//
// Replaces the TPU kernel tpuseg/ops/pallas_kernels.py:165 upsample2x_argmax
// (body _up_w_argmax_kernel, :151): logits f32 [B,H,W,C] -> classes uint8
// [B,2H,2W]. On the TPU the H contraction is an XLA einsum outside the
// kernel (:188-190) and the W contraction a matmul inside; here both are
// inside, as two 2-tap lerps.
//
// Bound on the H100: memory. At [8,64,128,10] it must read 2.6 MB and write
// 0.26 MB: 0.00086 ms at 3.35 TB/s, below the cost of one launch in a CUDA
// graph. At that size the instructions spent per output pixel, not the
// bytes, set the pace, so the design keeps them few: one barrier, no
// division in the loop, no tap computed twice.
//
// The x2 taps have a fixed shape: output 2m takes source columns m-1 and m
// (0 and 1 at m = 0), output 2m+1 takes m and m+1 (m alone at the last
// column), and the same holds for rows. So a thread owns one source pixel
// (k, m) and computes the 2x2 output block (2k, 2k+1) x (2m, 2m+1).
//
// Design: one CTA per image, band of BR source rows and segment of source
// columns (all of a row's columns where they fit).
//   1. It stages the source rows the band needs (BR + 2: one above, one
//      below), one contiguous span of floats each, into shared memory with
//      16-byte cp.async where the span's alignment allows: all in flight at
//      once, one wait, one barrier. The taps come meanwhile.
//   2. A warp takes one source row k and a run of 30 source columns: lane l
//      column m = 30 run + l - 1, lanes 0 and 31 only serving their columns
//      to their neighbours. Per class a lane lerps its column in H once for
//      each of its two output rows, takes columns m-1 and m+1 from lanes l-1
//      and l+1 by shuffles, and lerps in W for its two output columns,
//      keeping four running argmaxes.
//   3. It stores the 2x2 block as two 16-bit words.
// The taps are tables, one {lo, hi, 1 - frac, frac} per output row and
// column, made once per size by the wrapper from the plain version's own
// float64 taps (src = i*(n-1)/(2n-1), frac rounded to float32); a thread
// reads its four. Products and sums are rounded one by one
// (__fmul_rn/__fadd_rn, H then W), the order of the plain PyTorch version,
// and the running argmax takes a strict '>' so the first maximum wins:
// bit-equal to the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int SPAN = 30;               // source columns a warp owns
constexpr int SMEM_BUDGET = 160 * 1024;

// a pointer's place in its 16-byte line, in 4-byte words
__device__ __forceinline__ int al(const void* p) { return (int)(((uintptr_t)p >> 2) & 3); }

__device__ __forceinline__ float lerp_rn(float a, float wa, float b, float wb) {
  return __fadd_rn(__fmul_rn(a, wa), __fmul_rn(b, wb));
}

__device__ __forceinline__ void keep_max(float v, int k, float& best, int& best_k) {
  if (v > best) {
    best = v;
    best_k = k;
  }
}

// grid: B * bands * segments CTAs of br * runs warps. Shared memory:
// br + 2 staged source rows of `stride` floats.
__global__ void upsample2x_argmax_kernel(const float* __restrict__ x,
                                         const int4* __restrict__ row_taps,
                                         const int4* __restrict__ col_taps,
                                         uint8_t* __restrict__ out, int h, int w, int c,
                                         int br, int runs, int bands, int segs, int stride) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const int w2 = 2 * w;
  const int seg = blockIdx.x % segs, rest = blockIdx.x / segs;
  const int band = rest % bands, img = rest / bands;
  const int k0 = band * br, k1 = min(k0 + br, h);                 // source rows k0..k1-1
  const int r_lo = max(k0 - 1, 0), r_hi = min(k1, h - 1);         // staged rows
  const int j0 = seg * runs * SPAN;
  const int c_lo = max(j0 - 1, 0), c_hi = min(j0 + runs * SPAN, w - 1);   // staged columns
  const int n = (c_hi - c_lo + 1) * c;                            // floats per staged row

  // 1. stage rows r_lo..r_hi, columns c_lo..c_hi. Row r's span starts at
  // src and goes to smem float r * stride + al(src), so that both sides
  // share their alignment: 16-byte copies but for a head and a tail.
  for (int r = 0; r <= r_hi - r_lo; ++r) {
    const float* src = x + ((long long)(img * h + r_lo + r) * w + c_lo) * c;
    float* dst = smem + r * stride + al(src);
    const int head = min(n, (4 - al(src)) & 3);
    const int body = (n - head) / 4, tail0 = head + 4 * body;
    for (int e = tid; e < body; e += nt) cp_async16(dst + head + 4 * e, src + head + 4 * e, true);
    for (int e = tid; e < head + n - tail0; e += nt) {
      const int q = e < head ? e : tail0 + e - head;
      cp_async4(dst + q, src + q, true);
    }
  }
  cp_async_commit();

  // the taps of this thread's output rows 2k, 2k+1 and columns 2m, 2m+1
  const int wr = warp / runs, run = warp % runs;
  const int k = k0 + wr, m = j0 + run * SPAN + lane - 1;
  const bool row_ok = k < k1;
  const bool owns = row_ok && lane >= 1 && lane <= SPAN && m < w;
  int4 ta = make_int4(k0, k0, 0x3f800000, 0), tb = ta, t0 = make_int4(0, 0, 0x3f800000, 0);
  int4 t1 = t0;
  if (row_ok) {
    ta = __ldg(row_taps + 2 * k);
    tb = __ldg(row_taps + 2 * k + 1);
  }
  if (owns) {
    t0 = __ldg(col_taps + 2 * m);
    t1 = __ldg(col_taps + 2 * m + 1);
  }
  cp_async_wait_all();
  __syncthreads();

  // 2. this lane's column m (clamped into the staged span; a clamped
  // column's values are never used) in the staged rows of its output rows
  const int mc = min(max(m, c_lo), c_hi) - c_lo;
  auto row_ptr = [&](int r) {
    const float* src = x + ((long long)(img * h + r) * w + c_lo) * c;
    return smem + (r - r_lo) * stride + al(src) + mc * c;
  };
  const float *pa0 = row_ptr(ta.x), *pa1 = row_ptr(ta.y);   // output row 2k: rows lo, hi
  const float *pb0 = row_ptr(tb.x), *pb1 = row_ptr(tb.y);   // output row 2k+1
  const float wa0 = __int_as_float(ta.z), wa1 = __int_as_float(ta.w);
  const float wb0 = __int_as_float(tb.z), wb1 = __int_as_float(tb.w);
  // output column 2m takes columns (m-1 or m, m or m+1); 2m+1 takes (m, m or m+1)
  const bool lo0_left = t0.x < m, hi0_right = t0.y > m, hi1_right = t1.y > m;
  const float wc00 = __int_as_float(t0.z), wc01 = __int_as_float(t0.w);
  const float wc10 = __int_as_float(t1.z), wc11 = __int_as_float(t1.w);
  // the four outputs' values of class q
  auto values = [&](int q, float (&v)[4]) {
    const float va = lerp_rn(pa0[q], wa0, pa1[q], wa1);
    const float vb = lerp_rn(pb0[q], wb0, pb1[q], wb1);
    const float la = __shfl_up_sync(0xffffffffu, va, 1), ra = __shfl_down_sync(0xffffffffu, va, 1);
    const float lb = __shfl_up_sync(0xffffffffu, vb, 1), rb = __shfl_down_sync(0xffffffffu, vb, 1);
    v[0] = lerp_rn(lo0_left ? la : va, wc00, hi0_right ? ra : va, wc01);
    v[1] = lerp_rn(va, wc10, hi1_right ? ra : va, wc11);
    v[2] = lerp_rn(lo0_left ? lb : vb, wc00, hi0_right ? rb : vb, wc01);
    v[3] = lerp_rn(vb, wc10, hi1_right ? rb : vb, wc11);
  };
  float best[4];
  int bk[4] = {0, 0, 0, 0};
  values(0, best);
#pragma unroll 2
  for (int q = 1; q < c; ++q) {
    float v[4];
    values(q, v);
#pragma unroll
    for (int o = 0; o < 4; ++o) keep_max(v[o], q, best[o], bk[o]);
  }

  // 3. the 2x2 block: rows 2k, 2k+1 at columns 2m, 2m+1
  if (owns) {
    uint8_t* o = out + (long long)(img * 2 * h + 2 * k) * w2 + 2 * m;
    *reinterpret_cast<uint16_t*>(o) = (uint16_t)(bk[0] | bk[1] << 8);
    *reinterpret_cast<uint16_t*>(o + w2) = (uint16_t)(bk[2] | bk[3] << 8);
  }
}

}  // namespace

// Launches on `stream`; returns a cudaError_t (0 on success). row_taps
// [2H] and col_taps [2W] hold {lo, hi, float bits of 1 - frac, of frac}.
extern "C" int tpuseg_upsample2x_argmax(const float* x, const int4* row_taps,
                                        const int4* col_taps, uint8_t* out, int b, int h,
                                        int w, int c, void* stream) {
  if (b == 0 || h == 0 || w == 0) return (int)cudaGetLastError();
  if (c < 1 || c > 256 || w > 32767 || h > 32767 || ((uintptr_t)out & 1))
    return (int)cudaErrorInvalidValue;
  // the widest segment (runs of 30 columns, at most 8) and the most source
  // rows per CTA (4, else 2, else 1) whose staged rows fit
  const int runs_all = (w + SPAN - 1) / SPAN;
  int br = 4, runs = runs_all < 8 ? runs_all : 8;
  auto stride_of = [&](int ru) {
    const int cols = ru * SPAN + 2 < w ? ru * SPAN + 2 : w;
    return (cols * c + 3) / 4 * 4 + 4;
  };
  auto staged = [&](int rr, int ru) { return (long long)(rr + 2) * stride_of(ru) * 4; };
  while (staged(br, runs) > SMEM_BUDGET && runs > 1) --runs;
  while (staged(br, runs) > SMEM_BUDGET && br > 1) br /= 2;
  if (staged(br, runs) > SMEM_BUDGET) return (int)cudaErrorInvalidValue;
  while (br * runs > 32 && br > 1) br /= 2;      // 1024 threads at most
  const int stride = stride_of(runs), smem = (int)staged(br, runs);
  const int segs = (w + runs * SPAN - 1) / (runs * SPAN), bands = (h + br - 1) / br;
  const long long grid = (long long)b * bands * segs;
  if (grid >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(upsample2x_argmax_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  upsample2x_argmax_kernel<<<(unsigned)grid, 32 * br * runs, smem, (cudaStream_t)stream>>>(
      x, row_taps, col_taps, out, h, w, c, br, runs, bands, segs, stride);
  return (int)cudaGetLastError();
}
