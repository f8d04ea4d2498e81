// Per-pixel Lovász coefficient lookup: w[c, p] = coef[c, bin(errors[c, p])].
//
// Replaces the TPU kernel tpuseg/ops/lovasz_pallas.py:170 _lookup (body
// _lookup_kernel, :87): errors f32 [C, P], coef f32 [C, 256] -> w f32
// [C, P]. The bin is the one lovasz_histograms.cu uses,
// clip(trunc(e * 256), 0, 255); a pixel with e < 0 (or NaN) gets w = 0.
//
// Bound on the H100: memory. Each pixel reads 4 bytes and writes 4; at
// [10, 262144] that is 10.5 MB each way, about 6.3 us at 3.35 TB/s. The TPU
// had no gather and rebuilt the lookup as a one-hot matmul; here it is a
// gather from the class's coefficient row, staged once per block in shared
// memory (1 KB), so device memory sees only the error read and the w write.
// Design: a grid of (nblk, C) blocks of 256 threads; each thread walks a
// strided share of one class's pixels, so a warp's loads and stores are
// contiguous. The result is bit-equal to any gather of the same row.

#include <cuda_runtime.h>

#define NB 256
#define THREADS 256

__device__ __forceinline__ int bin_of(float e) {
  int b = __float2int_rz(e * 256.0f);
  return b < NB - 1 ? b : NB - 1;
}

__global__ void __launch_bounds__(THREADS)
lookup_kernel(const float* __restrict__ errors, const float* __restrict__ coef,
              float* __restrict__ w, long long p_len, int nblk) {
  __shared__ float row[NB];
  const int c = blockIdx.y;
  row[threadIdx.x] = coef[c * NB + threadIdx.x];
  __syncthreads();
  const long long base = (long long)c * p_len;
  const long long stride = (long long)nblk * THREADS;
  for (long long p = (long long)blockIdx.x * THREADS + threadIdx.x; p < p_len;
       p += stride) {
    const float e = __ldg(errors + base + p);
    w[base + p] = e >= 0.0f ? row[bin_of(e)] : 0.0f;
  }
}

// errors: f32 [c, p_len]; coef: f32 [c, 256]; w: f32 [c, p_len]. Launches
// on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int tpuseg_lovasz_lookup(const float* errors, const float* coef, float* w,
                                    int c, long long p_len, int nblk, void* stream) {
  if (c == 0 || p_len == 0) return (int)cudaGetLastError();
  lookup_kernel<<<dim3(nblk, c), THREADS, 0, (cudaStream_t)stream>>>(
      errors, coef, w, p_len, nblk);
  return (int)cudaGetLastError();
}
