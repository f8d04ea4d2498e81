// Per-class 256-bin histograms of {pixel count, foreground sum, error sum}
// for the sort-free Lovász-softmax loss.
//
// Replaces the TPU kernel tpuseg/ops/lovasz_pallas.py:124 _histograms (body
// _hist_kernel, :68): errors, fg f32 [C, P] -> hist f32 [C, 3, 256], where
// row 0 counts the pixels of each bin, row 1 sums fg and row 2 sums e. A
// pixel's bin is clip(trunc(e * 256), 0, 255), so e = 1.0 lands in bin 255;
// a pixel with e < 0 (or NaN) enters no bin (_one_hots, :51-65).
//
// Bound on the H100: memory. Each pixel is read once (e and fg), 8 bytes;
// at [10, 262144] that is 21 MB, 6.3 us at 3.35 TB/s, against 3 adds per
// pixel. The TPU built 16x16 one-hot matrices and contracted them on the
// MXU because it has no scatter; here the histogram is a scatter into
// shared memory with shared-memory atomics.
//
// What sets the pace is the number of loads in flight and the cost of the
// atomics. Softmax errors crowd into the lowest bins (18% of the training
// batch's pixels in bin 0), so the lanes of a warp often hit one bin at
// once; a thread that loads one pixel at a time keeps one 4-byte load in
// flight; and a float atomic add on shared memory is a compare-and-swap
// loop on sm_90 (ATOMS.CAST.SPIN), an integer one a single instruction.
// Design:
//   pass 1 (hist_partial): a grid of (nblk, C) blocks of 256 threads, two
//     resident on each SM; tpuseg_lovasz_hist_plan sizes nblk from the SM
//     count so that the C x nblk blocks fill those slots once. Each block
//     walks a strided share of one class's pixels. Each thread loads e and
//     fg together as float4s, 4 of each in flight (16 pixels), then adds 1
//     (an integer atomic), fg (a float atomic, skipped where fg is 0: most
//     of a one-hot plane) and e (a float atomic) into its lane's copy of
//     the histograms: 32 copies laid out [3][256 bins][32 lanes], so lane l
//     always hits bank l and no two lanes of a warp ever collide, whatever
//     their bins (96 KB of dynamic shared memory). A row of [C, P] starts
//     16-byte aligned only when c * P % 4 == 0, so each row has a scalar
//     head and tail of at most 3 pixels. The block then sums its 32 copies
//     (each thread reads them in a rotated order, so a warp's reads hit 32
//     banks) and writes one partial [3, 256] to scratch.
//   pass 2 (hist_reduce): one thread per (class, row, bin) sums the nblk
//     partials in block order, in double. No global atomics, and the
//     reduction across blocks has a fixed order.
// Exactness: counts are integers, and fg sums are sums of 0s and 1s. A
// block's share is exact in float while it holds fewer than 2^24 pixels
// (the plan keeps each under 2^23), and the double sum of the partials is
// exact, so each count and fg sum is the exact total rounded once to
// float, at any P: bit-equal to any other exact summation. Only the error
// sum depends on the order of the shared-memory atomics; it feeds the loss
// value, not the per-pixel coefficients.

#include <cuda_runtime.h>
#include <stdint.h>

#define NB 256
#define THREADS 256
#define COPIES 32
#define UNROLL 4
#define RESIDENT 2
#define BLOCK_PIXELS (1LL << 23)
#define SMEM_BYTES (3 * NB * COPIES * 4)

__device__ __forceinline__ int bin_of(float e) {
  // clip(trunc(e * 256), 0, 255) for e >= 0; e * 256 is exact in float,
  // and the conversion saturates for e far above 1
  int b = __float2int_rz(e * 256.0f);
  return b < NB - 1 ? b : NB - 1;
}

__global__ void __launch_bounds__(THREADS, RESIDENT)
hist_partial(const float* __restrict__ errors, const float* __restrict__ fg,
             float* __restrict__ partial, long long p_len, int nblk, int vec) {
  extern __shared__ __align__(16) float sh[];    // [3][NB][COPIES]; row 0 unsigned
  const int c = blockIdx.y, k = blockIdx.x, tid = threadIdx.x;
  float4* sh4 = reinterpret_cast<float4*>(sh);
  for (int i = tid; i < 3 * NB * COPIES / 4; i += THREADS) sh4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  float* mine = sh + (tid & 31);
  const auto add = [&](float e, float f) {
    if (!(e >= 0.0f)) return;
    const int b = bin_of(e) * COPIES;
    atomicAdd(reinterpret_cast<unsigned*>(mine) + b, 1u);
    if (f != 0.0f) atomicAdd(mine + NB * COPIES + b, f);
    atomicAdd(mine + 2 * NB * COPIES + b, e);
  };

  const long long row0 = (long long)c * p_len;
  const float* e_row = errors + row0;
  const float* f_row = fg + row0;
  long long head = p_len, n4 = 0;                // scalar pixels [0, head), then float4s
  if (vec) {
    head = (4 - (row0 & 3)) & 3;
    head = head < p_len ? head : p_len;
    n4 = (p_len - head) >> 2;
  }
  const long long step = (long long)nblk * THREADS;
  const long long first = (long long)k * THREADS + tid;
  for (long long p = first; p < head; p += step) add(__ldg(e_row + p), __ldg(f_row + p));
  for (long long p = head + 4 * n4 + first; p < p_len; p += step)
    add(__ldg(e_row + p), __ldg(f_row + p));

  const float4* e4 = reinterpret_cast<const float4*>(e_row + head);
  const float4* f4 = reinterpret_cast<const float4*>(f_row + head);
  long long i = first;
  for (; i + (UNROLL - 1) * step < n4; i += UNROLL * step) {
    float4 ev[UNROLL], fv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      ev[u] = __ldg(e4 + i + u * step);
      fv[u] = __ldg(f4 + i + u * step);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      add(ev[u].x, fv[u].x);
      add(ev[u].y, fv[u].y);
      add(ev[u].z, fv[u].z);
      add(ev[u].w, fv[u].w);
    }
  }
  for (; i < n4; i += step) {
    const float4 ev = __ldg(e4 + i), fv = __ldg(f4 + i);
    add(ev.x, fv.x);
    add(ev.y, fv.y);
    add(ev.z, fv.z);
    add(ev.w, fv.w);
  }
  __syncthreads();

  float* out = partial + ((long long)c * nblk + k) * 3 * NB;
  for (int j = tid; j < 3 * NB; j += THREADS) {
    const float* src = sh + j * COPIES;
    float s = 0.0f;
    if (j < NB) {                     // counts: integers, exact
      const unsigned* n = reinterpret_cast<const unsigned*>(src);
      unsigned total = 0;
#pragma unroll 8
      for (int l = 0; l < COPIES; ++l) total += n[(l + j) & (COPIES - 1)];
      s = (float)total;
    } else {
#pragma unroll 8
      for (int l = 0; l < COPIES; ++l) s += src[(l + j) & (COPIES - 1)];
    }
    out[j] = s;
  }
}

__global__ void __launch_bounds__(THREADS)
hist_reduce(const float* __restrict__ partial, float* __restrict__ hist, int nblk) {
  // grid (3, C): block (row, c), thread = bin
  const int c = blockIdx.y;
  const int i = blockIdx.x * NB + threadIdx.x;
  const float* src = partial + (long long)c * nblk * 3 * NB + i;
  double s = 0.0;
#pragma unroll 8
  for (int k = 0; k < nblk; ++k) s += (double)src[(long long)k * 3 * NB];
  hist[(long long)c * 3 * NB + i] = (float)s;
}

// Blocks per class for c classes of p_len pixels on a card with `sms` SMs:
// enough that the c * nblk blocks fill the RESIDENT slots of every SM once,
// but no more than give each thread 16 pixels, and never fewer than keep
// each block under BLOCK_PIXELS pixels (the exactness of its partials).
extern "C" int tpuseg_lovasz_hist_plan(int c, long long p_len, int sms, int* nblk) {
  if (c < 0 || p_len < 0 || sms < 1) return (int)cudaErrorInvalidValue;
  long long n = c > 0 ? (long long)RESIDENT * sms / c : 1;
  const long long most = (p_len + THREADS * 16 - 1) / (THREADS * 16);
  const long long least = (p_len + BLOCK_PIXELS - 1) / BLOCK_PIXELS;
  n = n < most ? n : most;
  n = n > least ? n : least;
  *nblk = (int)(n > 1 ? n : 1);
  return 0;
}

// errors, fg: f32 [c, p_len]; partial: f32 scratch [c, nblk, 3, 256];
// hist: f32 [c, 3, 256]. Launches both passes on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int tpuseg_lovasz_histograms(const float* errors, const float* fg,
                                        float* partial, float* hist, int c,
                                        long long p_len, int nblk, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (c == 0) return (int)cudaGetLastError();
  cudaError_t err = cudaFuncSetAttribute(hist_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int vec = ((uintptr_t)errors & 15) == 0 && ((uintptr_t)fg & 15) == 0;
  hist_partial<<<dim3(nblk, c), THREADS, SMEM_BYTES, s>>>(errors, fg, partial, p_len, nblk, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hist_reduce<<<dim3(3, c), NB, 0, s>>>(partial, hist, nblk);
  return (int)cudaGetLastError();
}
