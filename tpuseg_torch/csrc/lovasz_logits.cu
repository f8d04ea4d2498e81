// The Lovász-softmax region from logits to gradient, as two fused kernels.
//
// Replaces the region of the TPU function tpuseg/ops/lovasz_pallas.py:238
// make_sharded_lovasz (its body :265-289, under shard_map :291). There XLA
// built [C, P] error and foreground planes from the logits, the Pallas
// kernels _histograms (:124) and _lookup (:170) read them, and XLA ran the
// softmax chain back to the logits. Here no plane exists:
//
//   lovasz_logits_histograms: logits [P, C] (f32 or bf16) and int64 targets
//     -> hist f32 [3, C, 256]: per class and bin the pixel count, the fg
//     sum and the error sum (logits_hist_partial, then logits_hist_reduce);
//   lovasz_logits_grad: logits, targets and the histograms -> the loss
//     value and the f32 logits gradient [P, C] (logits_grad_kernel).
// Over ranks the caller sums the histograms between the two (one
// all_reduce); on one card nothing runs between them.
//
// Per pixel both kernels compute p = exp(log_softmax(x)) and, per class,
// e = |fg - p| * valid and its bin clip(trunc(e * 256), 0, 255) (a pixel
// with e < 0 or NaN enters no bin and gets w = 0). The softmax follows the
// order of torch's own CUDA log_softmax for C <= 32 (softmax_warp_forward
// in ATen's PersistentSoftmax.cuh): the max, the sum of exp(x - max) over
// a pairwise tree that pads the classes with zeros to a power of two (the
// warp's xor butterfly), log of the sum, then exp((x - max) - log sum).
// So the errors and bins equal those of the plain version's
// torch.exp(torch.log_softmax(x)) on the card wherever torch sums in that
// order; a build that sums in another can move only a pixel whose error
// lies within a few ulps of a bin edge (the card tests hold that bound).
// Ignored pixels (targets == ignore_index) enter bin 0 of every class with
// e = 0 and fg = 0, and get no gradient.
//
// Layout. Logits must be contiguous [B, H, W, C], which every training
// path gives: the captured one-card step's logits are the NHWC view of the
// channels_last model output, a mesh rank's are the same view of its rows,
// and a spatial rank's of its H-slab (each contiguous; the wrapper copies
// anything else and counts the copy). Targets are [B, H, W] with H and W
// dense and any batch stride: the spatial step's targets are an H-slab of
// the rank's labels, whose batch stride is the whole image's H * W.
//
// Bound on the H100: memory. The logits and targets are read once and the
// gradient written once (at [10, 131,072]: 11.5 MB, 3.44 us at 3.35
// TB/s); this design reads the logits and targets twice, once per kernel.
// A warp walks tiles of 32 pixels x C logits: each lane loads its share of
// the next tile into registers (coalesced) while the warp computes the
// current one from shared memory, where each lane reads its pixel's row;
// the gradient goes back through the tile and leaves in coalesced stores.
//
// What makes the histograms hard: softmax errors crowd into the lowest
// bins (a non-target class's e is its probability), so the 32 lanes of a
// warp often hit one bin of one class at once, and the 32 lane-private
// copies that lovasz_histograms.cu keeps for one class (96 KB) do not fit
// for C classes. On sm_90 a float or 64-bit add on shared memory is a
// compare-and-swap loop, which lanes on one address serialize, and a
// warp-level sum over the lanes of each bin (redux.sync with one mask per
// bin) serializes over the bins; a 32-bit integer add is one native
// atomic whatever the lanes share. So every histogram is kept in 32-bit
// integers, and each lane adds its own pixel: count += 1, fg += 1 on its
// label's class, and its error in fixed point relative to its bin's lower
// edge, r = e - b / 256 (exact in float, by Sterbenz's lemma; e itself in
// bin 0), in units of 2^-40 (at most 2^32, and exact while r >= 2^-16),
// added to a low word whose carry goes to a high word. Each block keeps one
// or two copies of these [4][C][256] words in shared memory (warp w adds
// into copy w % copies), sums them and writes one float partial, the
// error sum rebuilt in double as count * b / 256 + r * 2^-40; the second
// kernel sums the partials in block order in double. Exactness, as
// lovasz_histograms.cu:40-46: a block holds fewer than 2^23 pixels (the
// plan), so its counts and fg sums are exact in float, and the double sum
// of the partials is exact: each count and fg sum is the exact total
// rounded once, at any P. The error sums are integer sums too, so the
// histograms, and the loss value, repeat bit for bit.
//
// The gradient: every block first computes the per-bin coefficients from
// the histograms into shared memory (the suffix sums, the Jaccard steps and
// the present-class scale, in the float arithmetic of lovasz.coefficients,
// so the same histograms give the same coefficients while the sums stay
// below 2^24), and block 0 alone the loss value (the error sums times the
// coefficients, summed in a fixed order in double); then each pixel
// recomputes its softmax and errors, looks its coefficients up in the
// table, and writes dL/dz_k = wt_k p_k - p_k sum_c wt_c p_c with
// wt = w sign(p - fg) valid, the closed form that autodiff builds, rounded
// as the plain version rounds it (the class sum in class order, no fused
// multiply-add): where a pixel's bins agree, the two are bit-equal.

#include "sm90.cuh"

#define NB 256
#define THREADS 256
#define WARPS (THREADS / 32)
#define MAXC 32
#define RESIDENT 2
#define BLOCK_PIXELS (1LL << 23)
// the shared memory a histogram block may take with RESIDENT of them on an SM
#define HIST_SMEM_LIMIT (110 * 1024)

struct Pixels {
  long long p_len;       // pixels, B * H * W
  long long hw;          // pixels of one image, H * W
  long long t_bstride;   // the targets' batch stride in elements
  long long ignore;      // ignore_index, where has_ignore
  int c;                 // classes
  int has_ignore;
};

__device__ __forceinline__ unsigned bin_of(float e) {
  // clip(trunc(e * 256), 0, 255) for e >= 0; e * 256 is exact in float
  const int b = __float2int_rz(e * 256.0f);
  return (unsigned)(b < NB - 1 ? b : NB - 1);
}

__device__ __forceinline__ long long target_index(const Pixels& px, long long p) {
  if (px.t_bstride == px.hw) return p;
  const long long b = p / px.hw;
  return b * px.t_bstride + (p - b * px.hw);
}

// the tile `tix` of 32 pixels x c classes, contiguous in logits: lane l
// loads elements l, l + 32, ... of its n * c into buf
template <typename T, int MC>
__device__ __forceinline__ void load_tile(const T* __restrict__ logits, long long tix,
                                          long long p_len, int c, int lane, float (&buf)[MC]) {
  const long long p0 = tix << 5;
  const int count = (int)(p_len - p0 < 32 ? p_len - p0 : 32) * c;
  const T* src = logits + p0 * c;
#pragma unroll
  for (int i = 0; i < MC; ++i)
    if (i < c && lane + 32 * i < count) buf[i] = to_f32(src[lane + 32 * i]);
}

template <int MC>
__device__ __forceinline__ void store_tile(const float (&buf)[MC], int count, int c,
                                           float* tile, int lane) {
#pragma unroll
  for (int i = 0; i < MC; ++i)
    if (i < c && lane + 32 * i < count) tile[lane + 32 * i] = buf[i];
  __syncwarp();
}

// s[k] += s[k + O] for k < O, then O / 2, ...: the warp's xor butterfly
template <int O>
__device__ __forceinline__ void fold(float* s) {
#pragma unroll
  for (int k = 0; k < O; ++k) s[k] = s[k] + s[k + O];
  if constexpr (O > 1) fold<O / 2>(s);
}

// p[k] = exp(log_softmax(row)[k]) in the order of torch's warp softmax
template <int MC>
__device__ __forceinline__ void softmax_row(const float* row, int c, float (&p)[MC]) {
  float x[MC], s[MC];
  const float neg_inf = __uint_as_float(0xff800000u);
  float m = neg_inf;
#pragma unroll
  for (int k = 0; k < MC; ++k) {
    x[k] = k < c ? row[k] : neg_inf;
    m = m < x[k] ? x[k] : m;
  }
#pragma unroll
  for (int k = 0; k < MC; ++k) s[k] = k < c ? expf(x[k] - m) : 0.0f;
  fold<MC / 2>(s);
  const float ls = logf(s[0]);
#pragma unroll
  for (int k = 0; k < MC; ++k) p[k] = k < c ? expf((x[k] - m) - ls) : 0.0f;
}

__host__ __device__ inline int hist_copies(int c) {
  const int hist = 4 * c * NB * 4, tiles = WARPS * 32 * c * 4;
  return 2 * hist + tiles <= HIST_SMEM_LIMIT ? 2 : 1;
}

__host__ __device__ inline int hist_smem(int c) {
  return hist_copies(c) * 4 * c * NB * 4 + WARPS * 32 * c * 4;
}

template <typename T, int MC>
__global__ void __launch_bounds__(THREADS, RESIDENT)
logits_hist_partial(const T* __restrict__ logits, const long long* __restrict__ targets,
                    float* __restrict__ partial, Pixels px) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = px.c, copies = hist_copies(c), hsize = c * NB;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned* counts = reinterpret_cast<unsigned*>(smem);             // [copies][c][NB] each
  unsigned* fgs = counts + copies * hsize;
  unsigned* r_lo = fgs + copies * hsize;
  unsigned* r_hi = r_lo + copies * hsize;
  float* tile = reinterpret_cast<float*>(r_hi + copies * hsize) + warp * 32 * c;
  for (int i = threadIdx.x; i < 4 * copies * hsize; i += THREADS) counts[i] = 0u;
  __syncthreads();
  const int mine = (warp % copies) * hsize;

  const long long tiles = (px.p_len + 31) >> 5;
  const long long step = (long long)gridDim.x * WARPS;
  float buf[MC];
  long long tix = (long long)blockIdx.x * WARPS + warp;
  if (tix < tiles) load_tile(logits, tix, px.p_len, c, lane, buf);
  for (; tix < tiles; tix += step) {
    const long long p0 = tix << 5;
    const int n = (int)(px.p_len - p0 < 32 ? px.p_len - p0 : 32);
    store_tile(buf, n * c, c, tile, lane);
    if (tix + step < tiles) load_tile(logits, tix + step, px.p_len, c, lane, buf);
    const bool live = lane < n;
    float p[MC];
    softmax_row<MC>(tile + (live ? lane : 0) * c, c, p);
    const long long t = live ? __ldg(targets + target_index(px, p0 + lane)) : -1;
    const bool valid = !(px.has_ignore && t == px.ignore);
#pragma unroll
    for (int k = 0; k < MC; ++k) {
      const bool fg = valid && t == k;
      const float e = valid ? fabsf((fg ? 1.0f : 0.0f) - p[k]) : 0.0f;
      if (k < c && live && e >= 0.0f) {
        const unsigned b = bin_of(e);
        const int at = mine + k * NB + (int)b;
        atomicAdd(counts + at, 1u);
        if (fg) atomicAdd(fgs + at, 1u);
        // r = e - b / 256 in units of 2^-40: at most 2^32 (e = 1.0 in bin 255)
        const unsigned long long q =
            __float2ull_rn((e - (float)b * (1.0f / 256.0f)) * 1099511627776.0f);
        const unsigned lo = (unsigned)q;
        unsigned carry = (unsigned)(q >> 32);
        if (lo) carry += atomicAdd(r_lo + at, lo) > 0xffffffffu - lo;
        if (carry) atomicAdd(r_hi + at, carry);
      }
    }
    __syncwarp();                     // the next tile overwrites this one
  }
  __syncthreads();

  float* out = partial + (long long)blockIdx.x * 3 * hsize;
  for (int j = threadIdx.x; j < hsize; j += THREADS) {
    unsigned n = 0u, f = 0u;
    unsigned long long r = 0ull;
    for (int q = 0; q < copies; ++q) {
      const int i = q * hsize + j;
      n += counts[i];
      f += fgs[i];
      r += ((unsigned long long)r_hi[i] << 32) + r_lo[i];
    }
    out[j] = (float)n;
    out[hsize + j] = (float)f;
    out[2 * hsize + j] =
        (float)((double)n * ((j % NB) / 256.0) + (double)r * (1.0 / 1099511627776.0));
  }
}

// blocks of 32 x 8 threads: column x one of 32 consecutive outputs, row y
// the sum of partials y, y + 8, ... in order; row 0 then adds the 8 rows
// in order (a fixed order, in double)
__global__ void __launch_bounds__(THREADS)
logits_hist_reduce(const float* __restrict__ partial, float* __restrict__ hist, int n,
                   int nblk) {
  __shared__ double rows[WARPS][32];
  const int x = threadIdx.x & 31, y = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + x;
  double s = 0.0;
  if (i < n)
    for (int k = y; k < nblk; k += WARPS) s += (double)partial[(long long)k * n + i];
  rows[y][x] = s;
  __syncthreads();
  if (y == 0 && i < n) {
    double t = 0.0;
    for (int r = 0; r < WARPS; ++r) t += rows[r][x];
    hist[i] = (float)t;
  }
}

// 1 - (gts - f) / max(gts + n - f, 1), as lovasz.coefficients rounds it
__device__ __forceinline__ float jaccard(float gts, float n, float f) {
  return __fsub_rn(1.0f, __fdiv_rn(__fsub_rn(gts, f),
                                   fmaxf(__fsub_rn(__fadd_rn(gts, n), f), 1.0f)));
}

// The block's coefficient table [c][NB] from hist [3][c][NB], into `table`
// (n_cum, f_cum and s: [c][NB] of shared scratch each); with `value`, the
// loss value too (one block does that). Ends with the table visible to the
// block.
__device__ void coefficients(const float* __restrict__ hist, int c, float* table, float* n_cum,
                             float* f_cum, float* s, float* value) {
  __shared__ double part[THREADS];
  __shared__ float gts[MAXC], scale[MAXC];
  const float* h_n = hist;
  const float* h_f = hist + c * NB;
  if (value) {                                          // the error sums, staged
#pragma unroll 4
    for (int i = threadIdx.x; i < c * NB; i += THREADS) s[i] = hist[2 * c * NB + i];
  }
  // suffix sums from the top bin, a warp a class: lane l sums its bins
  // 8l..8l+7 from the top, then adds the lanes above it (sums of counts and
  // fg sums, integers: exact in any order below 2^24)
  const int lane = threadIdx.x & 31;
  for (int k = threadIdx.x >> 5; k < c; k += WARPS) {
    const int b0 = k * NB + 8 * lane;
    float n8[8], f8[8], n = 0.0f, f = 0.0f;
#pragma unroll
    for (int j = 7; j >= 0; --j) {
      n8[j] = n = n + h_n[b0 + j];
      f8[j] = f = f + h_f[b0 + j];
    }
    float above_n = n, above_f = f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float un = __shfl_down_sync(0xffffffffu, above_n, o);
      const float uf = __shfl_down_sync(0xffffffffu, above_f, o);
      if (lane + o < 32) {
        above_n += un;
        above_f += uf;
      }
    }
    above_n -= n;
    above_f -= f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      n_cum[b0 + j] = n8[j] + above_n;
      f_cum[b0 + j] = f8[j] + above_f;
    }
  }
  __syncthreads();
  // the present classes' mean; then each bin's Jaccard step, in place of
  // f_cum (a thread reads and writes its own bins)
  float present = 0.0f;
  for (int k = 0; k < c; ++k) present = __fadd_rn(present, f_cum[k * NB] > 0.0f ? 1.0f : 0.0f);
  if (threadIdx.x < c) {
    gts[threadIdx.x] = f_cum[threadIdx.x * NB];
    scale[threadIdx.x] = __fdiv_rn(gts[threadIdx.x] > 0.0f ? 1.0f : 0.0f, fmaxf(present, 1.0f));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < c * NB; i += THREADS)
    f_cum[i] = jaccard(gts[i / NB], n_cum[i], f_cum[i]);
  __syncthreads();
  double acc = 0.0;
  for (int i = threadIdx.x; i < c * NB; i += THREADS) {
    const int b = i % NB;
    const float next = b + 1 < NB ? f_cum[i + 1] : 0.0f;
    // the bin's count, exact: a difference of integer suffix sums
    const float count = b + 1 < NB ? n_cum[i] - n_cum[i + 1] : n_cum[i];
    const float w = __fmul_rn(__fdiv_rn(__fsub_rn(f_cum[i], next), fmaxf(count, 1.0f)),
                              scale[i / NB]);
    table[i] = w;
    if (value) acc += (double)__fmul_rn(s[i], w);
  }
  if (value) {
    part[threadIdx.x] = acc;
    __syncthreads();
    for (int half = THREADS / 2; half > 0; half >>= 1) {   // a fixed order
      if (threadIdx.x < half) part[threadIdx.x] += part[threadIdx.x + half];
      __syncthreads();
    }
    if (threadIdx.x == 0) value[0] = (float)part[0];
  }
  __syncthreads();
}

template <typename T, int MC>
__global__ void __launch_bounds__(THREADS, RESIDENT)
logits_grad_kernel(const T* __restrict__ logits, const long long* __restrict__ targets,
                   const float* __restrict__ hist, float* __restrict__ value,
                   float* __restrict__ grad, Pixels px) {
  extern __shared__ __align__(16) float sh[];
  const int c = px.c;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* table = sh;                                  // [c][NB]
  float* tile = sh + 3 * c * NB + warp * 32 * c;      // [32][c] per warp
  const long long tiles = (px.p_len + 31) >> 5;
  const long long step = (long long)gridDim.x * WARPS;
  float buf[MC];
  long long tix = (long long)blockIdx.x * WARPS + warp;
  if (tix < tiles) load_tile(logits, tix, px.p_len, c, lane, buf);   // in flight meanwhile
  // the tiles' room holds the staged error sums until the table is built
  coefficients(hist, c, table, sh + c * NB, sh + 2 * c * NB, sh + 3 * c * NB,
               blockIdx.x == 0 ? value : nullptr);
  for (; tix < tiles; tix += step) {
    const long long p0 = tix << 5;
    const int n = (int)(px.p_len - p0 < 32 ? px.p_len - p0 : 32);
    store_tile(buf, n * c, c, tile, lane);
    if (tix + step < tiles) load_tile(logits, tix + step, px.p_len, c, lane, buf);
    const bool live = lane < n;
    float* row = tile + (live ? lane : 0) * c;
    float p[MC];
    softmax_row<MC>(row, c, p);
    const long long t = live ? __ldg(targets + target_index(px, p0 + lane)) : -1;
    const bool valid = !(px.has_ignore && t == px.ignore);
    float wp[MC];
#pragma unroll
    for (int k = 0; k < MC; ++k) {
      wp[k] = 0.0f;
      if (k < c) {
        const bool fg = valid && t == k;
        const float f = fg ? 1.0f : 0.0f;
        const float e = valid ? fabsf(f - p[k]) : 0.0f;
        const float w = e >= 0.0f ? table[k * NB + bin_of(e)] : 0.0f;
        const float d = p[k] - f;
        const float sg = d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f);
        float wt = __fmul_rn(w, sg);
        if (px.has_ignore) wt = __fmul_rn(wt, valid ? 1.0f : 0.0f);
        wp[k] = __fmul_rn(wt, p[k]);
      }
    }
    float sum = wp[0];                // over the classes in order, as the plain version
#pragma unroll
    for (int k = 1; k < MC; ++k)
      if (k < c) sum = __fadd_rn(sum, wp[k]);
    __syncwarp();                     // every lane has read its row
    if (live) {
#pragma unroll
      for (int k = 0; k < MC; ++k)
        if (k < c) row[k] = __fsub_rn(wp[k], __fmul_rn(p[k], sum));
    }
    __syncwarp();
    float* dst = grad + p0 * c;
    for (int j = lane; j < n * c; j += 32) dst[j] = tile[j];
    __syncwarp();                     // the next tile overwrites this one
  }
}

// ---------------------------------------------------------------------------
// C entry points

// Histogram blocks for c classes of p_len pixels on a card with `sms` SMs:
// enough that RESIDENT of them fill every SM once, but no more than give
// each warp 4 tiles of 32 pixels, and never fewer than keep each block
// under BLOCK_PIXELS pixels (the exactness of its partials).
extern "C" int tpuseg_lovasz_logits_plan(int c, long long p_len, int sms, int* nblk) {
  if (c < 1 || c > MAXC || p_len < 0 || sms < 1) return (int)cudaErrorInvalidValue;
  long long n = (long long)RESIDENT * sms;
  const long long most = (p_len + THREADS * 4 - 1) / (THREADS * 4);
  const long long least = (p_len + BLOCK_PIXELS - 1) / BLOCK_PIXELS;
  n = n < most ? n : most;
  n = n > least ? n : least;
  *nblk = (int)(n > 1 ? n : 1);
  return 0;
}

template <typename T, int MC>
static cudaError_t launch_hist(const void* logits, const long long* targets, float* partial,
                               const Pixels& px, int nblk, cudaStream_t s) {
  const int smem = hist_smem(px.c);
  cudaError_t err = cudaFuncSetAttribute(logits_hist_partial<T, MC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  logits_hist_partial<T, MC><<<nblk, THREADS, smem, s>>>(static_cast<const T*>(logits), targets,
                                                          partial, px);
  return cudaGetLastError();
}

template <typename T, int MC>
static cudaError_t launch_grad(const void* logits, const long long* targets, const float* hist,
                               float* value, float* grad, const Pixels& px, int nblk,
                               cudaStream_t s) {
  const int smem = (3 * px.c * NB + WARPS * 32 * px.c) * 4;
  cudaError_t err = cudaFuncSetAttribute(logits_grad_kernel<T, MC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  logits_grad_kernel<T, MC><<<nblk, THREADS, smem, s>>>(static_cast<const T*>(logits), targets,
                                                         hist, value, grad, px);
  return cudaGetLastError();
}

static Pixels make_pixels(int c, long long p_len, long long hw, long long t_bstride,
                          int has_ignore, long long ignore) {
  Pixels px;
  px.p_len = p_len;
  px.hw = hw > 0 ? hw : 1;
  px.t_bstride = t_bstride;
  px.ignore = ignore;
  px.c = c;
  px.has_ignore = has_ignore;
  return px;
}

// logits: [p_len, c] f32 (bf16 nonzero: bf16); targets: int64 [B, H, W], H
// and W dense, batch stride t_bstride; partial: f32 scratch
// [nblk, 3, c, 256]; hist: f32 [3, c, 256]. Launches both passes on
// `stream`; returns cudaGetLastError() (0 on success).
extern "C" int tpuseg_lovasz_logits_histograms(const void* logits, const long long* targets,
                                               float* partial, float* hist, int c,
                                               long long p_len, long long hw,
                                               long long t_bstride, int has_ignore,
                                               long long ignore, int nblk, int bf16,
                                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (c < 1 || c > MAXC || nblk < 1) return (int)cudaErrorInvalidValue;
  const int n = 3 * c * NB;
  if (p_len == 0) return (int)cudaMemsetAsync(hist, 0, (size_t)n * 4, s);
  const Pixels px = make_pixels(c, p_len, hw, t_bstride, has_ignore, ignore);
  cudaError_t err;
  if (bf16)
    err = c <= 16 ? launch_hist<__nv_bfloat16, 16>(logits, targets, partial, px, nblk, s)
                  : launch_hist<__nv_bfloat16, MAXC>(logits, targets, partial, px, nblk, s);
  else
    err = c <= 16 ? launch_hist<float, 16>(logits, targets, partial, px, nblk, s)
                  : launch_hist<float, MAXC>(logits, targets, partial, px, nblk, s);
  if (err != cudaSuccess) return (int)err;
  logits_hist_reduce<<<(n + 31) / 32, THREADS, 0, s>>>(partial, hist, n, nblk);
  return (int)cudaGetLastError();
}

// logits, targets as above; hist: f32 [3, c, 256]; value: f32 [1]; grad:
// f32 [p_len, c]. Launches the gradient pass, whose every block computes
// the coefficients and whose block 0 writes the value, on `stream`;
// returns cudaGetLastError() (0 on success).
extern "C" int tpuseg_lovasz_logits_grad(const void* logits, const long long* targets,
                                         const float* hist, float* value, float* grad, int c,
                                         long long p_len, long long hw, long long t_bstride,
                                         int has_ignore, long long ignore, int nblk, int bf16,
                                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (c < 1 || c > MAXC || nblk < 1) return (int)cudaErrorInvalidValue;
  const Pixels px = make_pixels(c, p_len, hw, t_bstride, has_ignore, ignore);
  cudaError_t err;
  if (bf16)
    err = c <= 16 ? launch_grad<__nv_bfloat16, 16>(logits, targets, hist, value, grad, px, nblk, s)
                  : launch_grad<__nv_bfloat16, MAXC>(logits, targets, hist, value, grad, px, nblk, s);
  else
    err = c <= 16 ? launch_grad<float, 16>(logits, targets, hist, value, grad, px, nblk, s)
                  : launch_grad<float, MAXC>(logits, targets, hist, value, grad, px, nblk, s);
  return (int)err;
}
