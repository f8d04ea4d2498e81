// Fused per-pixel argmax + palette lookup for the serving path's overlay.
//
// Replaces the TPU kernel tpuseg/ops/pallas_kernels.py:63 argmax_colorize
// (body _argmax_colorize_kernel, :46): logits f32 or bf16 [B,H,W,C] -> class
// map uint8 [B,H,W] and packed colour uint32 [B,H,W] (0x00RRGGBB, packed as
// _pack_palette :33). The argmax uses a strict '>' so the first maximum
// wins, as the TPU kernel and jnp.argmax do. bf16 logits are widened to f32
// as they are read (exact), so the picks are those of the f32 kernel on the
// widened values.
//
// Bound on the H100: memory. Each pixel reads C floats and writes 5 bytes;
// at [8,128,256,10] that is 10.5 MB read and 1.3 MB written, against about
// 30 operations per pixel. Design: one thread per pixel, so a warp's loads
// cover one contiguous 32*C*4-byte span that L1 serves over the C loop; the
// logits are read from device memory once, the class and colour are
// written once, and nothing else touches device memory. The TPU kernel's
// lane layout (W on lanes, a chain of C selects) has no counterpart here:
// the palette is a C-entry array read through the read-only cache.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

template <typename T>
__global__ void argmax_colorize_kernel(const T* __restrict__ logits,
                                       const uint32_t* __restrict__ palette,
                                       uint8_t* __restrict__ classes,
                                       uint32_t* __restrict__ colors,
                                       long long n_pix, int c) {
  long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pix) return;
  const T* row = logits + p * c;
  float best = to_f32(row[0]);
  int idx = 0;
  for (int k = 1; k < c; ++k) {
    float v = to_f32(row[k]);
    if (v > best) {
      best = v;
      idx = k;
    }
  }
  classes[p] = (uint8_t)idx;
  colors[p] = __ldg(palette + idx);
}

// Launches on `stream`; returns cudaGetLastError() (0 on success). The
// logits are bf16 when `bf16` is nonzero, else f32.
extern "C" int tpuseg_argmax_colorize(const void* logits, const uint32_t* palette,
                                      uint8_t* classes, uint32_t* colors,
                                      long long n_pix, int c, int bf16, void* stream) {
  if (n_pix == 0) return (int)cudaGetLastError();
  const int threads = 256;
  long long blocks = (n_pix + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    argmax_colorize_kernel<<<(unsigned)blocks, threads, 0, s>>>(
        (const __nv_bfloat16*)logits, palette, classes, colors, n_pix, c);
  else
    argmax_colorize_kernel<<<(unsigned)blocks, threads, 0, s>>>(
        (const float*)logits, palette, classes, colors, n_pix, c);
  return (int)cudaGetLastError();
}
