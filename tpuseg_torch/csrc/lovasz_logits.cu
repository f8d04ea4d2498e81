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
// all_reduce); on one card nothing runs between them. Any number of classes
// C >= 1: up to MAXC (32) the kernels below, with a lane per pixel; above,
// the kernels of the section "More than MAXC classes", with the same
// contract.
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
// More than MAXC classes
//
// A lane per pixel and per-lane arrays of C values do not scale past a few
// dozen classes, and neither do [4][C][256] histogram words in one block
// (4 KB a class against the 227 KB a block may have). So above MAXC the
// region runs as these kernels behind the same two entry points:
//
//   logits_row_stats: a warp a pixel, as torch's softmax_warp_forward lays
//     it out (lane l holds classes l + 32 i), computes the softmax's max m
//     and log-sum ls and writes them, [P] float2;
//   logits_hist_groups: class groups of at most GMAX classes (gridDim.x
//     over pixel blocks x groups, the groups of one pixel block adjacent,
//     so that they read the same rows at about the same time); the lanes of
//     a warp walk its 32 pixels' (pixel, class) pairs of the group in row
//     order, so one atomic instruction adds to up to 32 different classes
//     (rows padded to NBP words: different banks) and never to one address
//     twice, however the errors crowd into bin 0. The block keeps 32-bit
//     integer counts, fg counts and error offsets (r split into its low 16
//     bits and the rest, two words that no carry links: no atomic waits for
//     its old value; the plan keeps a block under 2^16 pixels, so neither
//     word overflows), and adds them at its end into 64-bit integer totals
//     in global memory (one atomic a nonzero word; integer sums repeat bit
//     for bit in any order);
//   logits_hist_finish: the totals -> hist f32 [3, C, 256], each count and
//     fg sum the exact total rounded once, each error sum count * b / 256 +
//     r * 2^-40 in double rounded once;
//   logits_coef_classes, logits_coef_scale, logits_value: the coefficient
//     table [C, 256] with the float arithmetic of coefficients() above (a
//     warp a class for the suffix sums and Jaccard steps; the present
//     classes counted exactly, as integers; the scale), and the value, the
//     products summed in a fixed order in double (each block's share, then
//     the blocks' partials in order);
//   logits_grad_wide: a warp a pixel again recomputes m and ls, then p_k,
//     its coefficient (the table staged in shared memory with rows padded to
//     NBP where it fits, else read through the cache) and wt_k p_k, sums
//     wt p over the classes in the order of the softmax's sum (each lane
//     over its classes in order from zero, then the butterfly), and writes
//     the gradient. The plain closed form sums in that order above 32
//     classes, so where a pixel's bins agree the two are bit-equal.
//
// The softmax in torch's order above 32 classes: softmax_warp_forward runs
// 32 lanes, lane l summing exp(x - max) over its classes l + 32 it in
// order, then the xor butterfly over the lanes. warp_stats is that warp,
// for WARP_PIX pixels at once (their loads and shuffles interleaved). So up
// to 1024 classes (where torch leaves the warp kernel for a block-wide one)
// p equals the plain version's; above 1024 this is the order used, and p
// may part from torch's by a few ulps (the checks allow a pixel at a bin
// edge to move). A lane keeps its first STAT_IT classes in registers and
// reads the rest again (more than 32 x STAT_IT classes): no class count is
// refused.
//
// Bound on the H100: memory, the logits and targets read once and the
// gradient written once (at [66, 262,144]: 140.5 MB, 0.042 ms). This path
// reads the logits three times (stats, groups, gradient), and its time is
// several times that bound (PERF.md): with a warp a pixel, 66 classes
// fill 66 of a lane's 96 slots, and the measured kernels move far below
// the memory rate, so their instructions and latencies hold them back.

#define ROW_THREADS 256
#define ROW_WARPS (ROW_THREADS / 32)
#define STAT_IT 4                  // classes a lane keeps in registers: 32 x 4 = 128 a pixel
#define WARP_PIX 2                 // pixels a warp takes at once
#define GROUP_THREADS 512
#define GROUP_WARPS (GROUP_THREADS / 32)
#define GROUP_RESIDENT 2           // histogram blocks on an SM
#define GMAX 26                    // classes a histogram block keeps: 4 x 26 x 257 words, 104 KB
#define NBP (NB + 1)               // a class's bins in shared memory, padded by one word
#define GROUP_TILES (GROUP_WARPS * 127)   // a block's tiles of 32 pixels: under 2^16 pixels
#define LOADS 8                    // loads a lane keeps in flight
#define TABLE_SMEM (100 * 1024)    // the most table a gradient block stages (two blocks on an SM)
#define SCALE_SPAN 2048            // table entries a block of logits_coef_scale takes

__host__ __device__ inline int groups_of(int c) { return (c + GMAX - 1) / GMAX; }

__host__ __device__ inline int group_size(int c) {
  const int g = groups_of(c);
  return (c + g - 1) / g;
}

__host__ __device__ inline long long scale_blocks(int c) {
  return ((long long)c * NB + SCALE_SPAN - 1) / SCALE_SPAN;
}

__device__ __forceinline__ float larger(float a, float b) { return a < b ? b : a; }

// (m, ls) of pixels p0 .. p0 + WARP_PIX - 1 (those below p_len), a warp
// each, in the order of torch's softmax_warp_forward; x[q][i] keeps class
// lane + 32 i of pixel p0 + q (-inf past c)
template <typename T>
__device__ __forceinline__ void warp_stats(const T* __restrict__ logits, long long p0,
                                           long long p_len, int c, int lane,
                                           float (&x)[WARP_PIX][STAT_IT],
                                           float2 (&st)[WARP_PIX]) {
  const float neg_inf = __uint_as_float(0xff800000u);
  float m[WARP_PIX], s[WARP_PIX];
#pragma unroll
  for (int q = 0; q < WARP_PIX; ++q) {
    const bool live = p0 + q < p_len;
    const T* row = logits + (p0 + q) * c;
#pragma unroll
    for (int i = 0; i < STAT_IT; ++i)
      x[q][i] = live && lane + 32 * i < c ? to_f32(row[lane + 32 * i]) : neg_inf;
  }
#pragma unroll
  for (int q = 0; q < WARP_PIX; ++q) {
    m[q] = x[q][0];
#pragma unroll
    for (int i = 1; i < STAT_IT; ++i) m[q] = larger(m[q], x[q][i]);
    if (p0 + q < p_len)
      for (int k = lane + 32 * STAT_IT; k < c; k += 32)
        m[q] = larger(m[q], to_f32(logits[(p0 + q) * c + k]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int q = 0; q < WARP_PIX; ++q) m[q] = larger(m[q], __shfl_xor_sync(0xffffffffu, m[q], o));
#pragma unroll
  for (int q = 0; q < WARP_PIX; ++q) {
    s[q] = 0.0f;
    if (p0 + q < p_len) {
#pragma unroll
      for (int i = 0; i < STAT_IT; ++i)
        if (lane + 32 * i < c) s[q] += expf(x[q][i] - m[q]);
      for (int k = lane + 32 * STAT_IT; k < c; k += 32)
        s[q] += expf(to_f32(logits[(p0 + q) * c + k]) - m[q]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int q = 0; q < WARP_PIX; ++q) s[q] = s[q] + __shfl_xor_sync(0xffffffffu, s[q], o);
#pragma unroll
  for (int q = 0; q < WARP_PIX; ++q) st[q] = make_float2(m[q], logf(s[q]));
}

template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
logits_row_stats(const T* __restrict__ logits, float2* __restrict__ stats, Pixels px) {
  const int lane = threadIdx.x & 31;
  const long long step = (long long)gridDim.x * ROW_WARPS * WARP_PIX;
  for (long long p0 = ((long long)blockIdx.x * ROW_WARPS + (threadIdx.x >> 5)) * WARP_PIX;
       p0 < px.p_len; p0 += step) {
    float x[WARP_PIX][STAT_IT];
    float2 st[WARP_PIX];
    warp_stats(logits, p0, px.p_len, px.c, lane, x, st);
#pragma unroll
    for (int q = 0; q < WARP_PIX; ++q)
      if (lane == q && p0 + q < px.p_len) stats[p0 + q] = st[q];
  }
}

template <typename T>
__global__ void __launch_bounds__(GROUP_THREADS)
logits_hist_groups(const T* __restrict__ logits, const long long* __restrict__ targets,
                   const float2* __restrict__ stats, unsigned long long* __restrict__ acc,
                   Pixels px) {
  extern __shared__ __align__(16) unsigned hs[];
  const int c = px.c, ngroups = groups_of(c), gsize = group_size(c);
  const int g = blockIdx.x % ngroups;
  const long long pb = blockIdx.x / ngroups, nb = gridDim.x / ngroups;
  const int c0 = g * gsize, gn = c - c0 < gsize ? c - c0 : gsize;
  const int words = gsize * NBP;
  unsigned* counts = hs;                                    // [gsize][NBP] each
  unsigned* fgs = counts + words;
  unsigned* r_lo = fgs + words;                             // r's low 16 bits
  unsigned* r_hi = r_lo + words;                            // r >> 16
  for (int i = threadIdx.x; i < 4 * words; i += GROUP_THREADS) hs[i] = 0u;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long tiles = (px.p_len + 31) >> 5;
  for (long long tix = pb * GROUP_WARPS + warp; tix < tiles; tix += nb * GROUP_WARPS) {
    const long long p0 = tix << 5;
    const int n = (int)(px.p_len - p0 < 32 ? px.p_len - p0 : 32);
    // lane l holds pixel p0 + l's stats and label; the lanes on its pairs
    // take them by shuffle
    float2 st = make_float2(0.0f, 0.0f);
    long long t = -1;
    if (lane < n) {
      st = stats[p0 + lane];
      t = __ldg(targets + target_index(px, p0 + lane));
    }
    const int total = n * gn;
    int r = lane / gn, col = lane % gn;                     // pair j = r * gn + col
    const T* src = logits + p0 * c + c0;
    for (int j0 = 0; j0 < total; j0 += 32 * LOADS) {
      float v[LOADS];
      int rr[LOADS], cc[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        rr[u] = r;
        cc[u] = col;
        v[u] = j0 + 32 * u + lane < total ? to_f32(src[(long long)r * c + col]) : 0.0f;
        col += 32;
        while (col >= gn) {
          col -= gn;
          ++r;
        }
      }
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int from = rr[u] & 31;
        const float m = __shfl_sync(0xffffffffu, st.x, from);
        const float ls = __shfl_sync(0xffffffffu, st.y, from);
        const long long tu = __shfl_sync(0xffffffffu, t, from);
        if (j0 + 32 * u + lane >= total) continue;
        const bool valid = !(px.has_ignore && tu == px.ignore);
        const bool fg = valid && tu == c0 + cc[u];
        const float p = expf((v[u] - m) - ls);
        const float e = valid ? fabsf((fg ? 1.0f : 0.0f) - p) : 0.0f;
        if (!(e >= 0.0f)) continue;
        const unsigned b = bin_of(e);
        const int at = cc[u] * NBP + (int)b;
        atomicAdd(counts + at, 1u);
        if (fg) atomicAdd(fgs + at, 1u);
        // r = e - b / 256 in units of 2^-40, as logits_hist_partial: at most 2^32
        const unsigned long long q =
            __float2ull_rn((e - (float)b * (1.0f / 256.0f)) * 1099511627776.0f);
        const unsigned lo = (unsigned)q & 0xffffu, hi = (unsigned)(q >> 16);
        if (lo) atomicAdd(r_lo + at, lo);
        if (hi) atomicAdd(r_hi + at, hi);
      }
    }
  }
  __syncthreads();

  const long long plane = (long long)c * NB;
  for (int i = threadIdx.x; i < gn * NB; i += GROUP_THREADS) {
    const int at = (i >> 8) * NBP + (i & (NB - 1));
    const long long o = (long long)c0 * NB + i;
    const unsigned n = counts[at], f = fgs[at];
    const unsigned long long r = ((unsigned long long)r_hi[at] << 16) + r_lo[at];
    if (n) atomicAdd(acc + o, (unsigned long long)n);
    if (f) atomicAdd(acc + plane + o, (unsigned long long)f);
    if (r) atomicAdd(acc + 2 * plane + o, r);
  }
}

__global__ void __launch_bounds__(THREADS)
logits_hist_finish(const unsigned long long* __restrict__ acc, float* __restrict__ hist,
                   long long n) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const unsigned long long count = acc[i], r = acc[2 * n + i];
  hist[i] = (float)count;
  hist[n + i] = (float)acc[n + i];
  hist[2 * n + i] =
      (float)((double)count * ((i % NB) / 256.0) + (double)r * (1.0 / 1099511627776.0));
}

// A warp a class k of hist [3][c][NB]: as coefficients() above, the suffix
// sums of the lane's bins 8l..8l+7 and of the lanes above, each bin's
// Jaccard step over its count into table (not yet scaled), and the class's
// fg total into gts[k]
__global__ void __launch_bounds__(THREADS)
logits_coef_classes(const float* __restrict__ hist, int c, float* __restrict__ table,
                    float* __restrict__ gts) {
  const int k = blockIdx.x * WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (k >= c) return;                 // a whole warp
  const float* h_n = hist;
  const float* h_f = hist + (long long)c * NB;
  const long long b0 = (long long)k * NB + 8 * lane;
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
  float n_cum[8], jac[8];
  const float g = __shfl_sync(0xffffffffu, f8[0] + above_f, 0);   // the class's fg total
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    n_cum[j] = n8[j] + above_n;
    jac[j] = jaccard(g, n_cum[j], f8[j] + above_f);
  }
  const float jac_up = __shfl_down_sync(0xffffffffu, jac[0], 1);
  const float n_up = __shfl_down_sync(0xffffffffu, n_cum[0], 1);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const bool top = lane == 31 && j == 7;
    const float next = j < 7 ? jac[j + 1] : (top ? 0.0f : jac_up);
    // the bin's count, exact: a difference of integer suffix sums
    const float count = j < 7 ? n_cum[j] - n_cum[j + 1] : (top ? n_cum[7] : n_cum[7] - n_up);
    table[b0 + j] = __fdiv_rn(__fsub_rn(jac[j], next), fmaxf(count, 1.0f));
  }
  if (lane == 0) gts[k] = g;
}

// SCALE_SPAN entries of the table a block: each scaled by its class's
// present-class share (the present classes counted as integers, which is
// what their float sum in class order gives below 2^24), and the block's
// share of the value, sum of error sum x coefficient, in a fixed order in
// double into part[blockIdx.x]
__global__ void __launch_bounds__(THREADS)
logits_coef_scale(const float* __restrict__ hist, int c, float* __restrict__ table,
                  const float* __restrict__ gts, double* __restrict__ part) {
  __shared__ double sums[THREADS];
  int present = 0;
  for (int base = 0; base < c; base += THREADS)
    present += __syncthreads_count(base + threadIdx.x < c && gts[base + threadIdx.x] > 0.0f);
  const float share = fmaxf((float)present, 1.0f);
  const long long plane = (long long)c * NB, i0 = (long long)blockIdx.x * SCALE_SPAN;
  const float* h_s = hist + 2 * plane;
  double sum = 0.0;
#pragma unroll
  for (int j = 0; j < SCALE_SPAN / THREADS; ++j) {
    const long long i = i0 + j * THREADS + threadIdx.x;
    if (i < plane) {
      const float w = __fmul_rn(table[i], __fdiv_rn(gts[i >> 8] > 0.0f ? 1.0f : 0.0f, share));
      table[i] = w;
      sum += (double)__fmul_rn(h_s[i], w);
    }
  }
  sums[threadIdx.x] = sum;
  __syncthreads();
  for (int half = THREADS / 2; half > 0; half >>= 1) {   // a fixed order
    if (threadIdx.x < half) sums[threadIdx.x] += sums[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) part[blockIdx.x] = sums[0];
}

// the value: the blocks' shares summed in a fixed order, in one block
__global__ void __launch_bounds__(THREADS)
logits_value(const double* __restrict__ part, long long n, float* __restrict__ value) {
  __shared__ double sums[THREADS];
  double sum = 0.0;
  for (long long i = threadIdx.x; i < n; i += THREADS) sum += part[i];
  sums[threadIdx.x] = sum;
  __syncthreads();
  for (int half = THREADS / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) sums[threadIdx.x] += sums[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) value[0] = (float)sums[0];
}

// wt_k p_k of one class of a pixel, rounded as the plain closed form (tab:
// the table, its rows `stride` floats apart)
__device__ __forceinline__ float weighted(float p, int k, long long t, bool valid, int has_ignore,
                                          const float* tab, int stride) {
  const bool fg = valid && t == k;
  const float f = fg ? 1.0f : 0.0f;
  const float e = valid ? fabsf(f - p) : 0.0f;
  const float w = e >= 0.0f ? tab[(long long)k * stride + bin_of(e)] : 0.0f;
  const float d = p - f;
  const float sg = d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f);
  float wt = __fmul_rn(w, sg);
  if (has_ignore) wt = __fmul_rn(wt, valid ? 1.0f : 0.0f);
  return __fmul_rn(wt, p);
}

template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
logits_grad_wide(const T* __restrict__ logits, const long long* __restrict__ targets,
                 const float* __restrict__ table, float* __restrict__ grad, Pixels px,
                 int table_smem) {
  extern __shared__ __align__(16) float staged[];          // [c][NBP] with table_smem
  const int c = px.c, lane = threadIdx.x & 31;
  const float* tab = table;
  int stride = NB;
  if (table_smem) {
    for (int i = threadIdx.x; i < c * NB; i += ROW_THREADS)
      staged[(i >> 8) * NBP + (i & (NB - 1))] = table[i];
    __syncthreads();
    tab = staged;
    stride = NBP;
  }
  const long long step = (long long)gridDim.x * ROW_WARPS * WARP_PIX;
  for (long long p0 = ((long long)blockIdx.x * ROW_WARPS + (threadIdx.x >> 5)) * WARP_PIX;
       p0 < px.p_len; p0 += step) {
    float x[WARP_PIX][STAT_IT], wp[WARP_PIX][STAT_IT], sum[WARP_PIX];
    float2 st[WARP_PIX];
    long long t[WARP_PIX];
    bool valid[WARP_PIX];
    warp_stats(logits, p0, px.p_len, c, lane, x, st);
#pragma unroll
    for (int q = 0; q < WARP_PIX; ++q) {
      const bool live = p0 + q < px.p_len;
      t[q] = live ? __ldg(targets + target_index(px, p0 + q)) : -1;
      valid[q] = !(px.has_ignore && t[q] == px.ignore);
      // x[q][i] becomes p, wp[q][i] wt p (0 past c); this lane's sum of wt p
      // over its classes in order, from zero, as the softmax's sum
      sum[q] = 0.0f;
#pragma unroll
      for (int i = 0; i < STAT_IT; ++i) {
        const int k = lane + 32 * i;
        wp[q][i] = 0.0f;
        if (live && k < c) {
          x[q][i] = expf((x[q][i] - st[q].x) - st[q].y);
          wp[q][i] = weighted(x[q][i], k, t[q], valid[q], px.has_ignore, tab, stride);
        }
        sum[q] = __fadd_rn(sum[q], wp[q][i]);
      }
      if (live)
        for (int k = lane + 32 * STAT_IT; k < c; k += 32) {
          const float p = expf((to_f32(logits[(p0 + q) * c + k]) - st[q].x) - st[q].y);
          sum[q] = __fadd_rn(sum[q], weighted(p, k, t[q], valid[q], px.has_ignore, tab, stride));
        }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int q = 0; q < WARP_PIX; ++q)
        sum[q] = __fadd_rn(sum[q], __shfl_xor_sync(0xffffffffu, sum[q], o));
#pragma unroll
    for (int q = 0; q < WARP_PIX; ++q) {
      if (p0 + q >= px.p_len) continue;
      float* out = grad + (p0 + q) * c;
#pragma unroll
      for (int i = 0; i < STAT_IT; ++i) {
        const int k = lane + 32 * i;
        if (k < c) out[k] = __fsub_rn(wp[q][i], __fmul_rn(x[q][i], sum[q]));
      }
      for (int k = lane + 32 * STAT_IT; k < c; k += 32) {
        const float p = expf((to_f32(logits[(p0 + q) * c + k]) - st[q].x) - st[q].y);
        out[k] = __fsub_rn(weighted(p, k, t[q], valid[q], px.has_ignore, tab, stride),
                           __fmul_rn(p, sum[q]));
      }
    }
  }
}

// the blocks of `kernel` that fill the card once at `smem` bytes a block,
// at most `want` (at least 1)
template <typename K>
static cudaError_t fill_blocks(K kernel, int threads, int smem, long long want, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  const long long fill = (long long)sms * (per_sm > 1 ? per_sm : 1);
  *blocks = (int)(want < fill ? (want > 1 ? want : 1) : fill);
  return err;
}

template <typename T>
static cudaError_t hist_wide(const void* logits, const long long* targets, void* scratch,
                             float* hist, const Pixels& px, int nblk, cudaStream_t s) {
  const int c = px.c, ngroups = groups_of(c);
  float2* stats = static_cast<float2*>(scratch);                       // [p_len]
  unsigned long long* acc = reinterpret_cast<unsigned long long*>(stats + px.p_len);
  const long long plane = (long long)c * NB;
  const long long want = (px.p_len + ROW_WARPS * WARP_PIX - 1) / (ROW_WARPS * WARP_PIX);
  int blocks;
  cudaError_t err = fill_blocks(logits_row_stats<T>, ROW_THREADS, 0, want, &blocks);
  if (err != cudaSuccess) return err;
  logits_row_stats<T><<<blocks, ROW_THREADS, 0, s>>>(static_cast<const T*>(logits), stats, px);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = cudaMemsetAsync(acc, 0, (size_t)(3 * plane) * 8, s)) != cudaSuccess) return err;
  const int gsmem = 4 * group_size(c) * NBP * 4;
  err = cudaFuncSetAttribute(logits_hist_groups<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             gsmem);
  if (err != cudaSuccess) return err;
  logits_hist_groups<T><<<nblk * ngroups, GROUP_THREADS, gsmem, s>>>(
      static_cast<const T*>(logits), targets, stats, acc, px);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  logits_hist_finish<<<(int)((plane + THREADS - 1) / THREADS), THREADS, 0, s>>>(acc, hist,
                                                                               plane);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t grad_wide(const void* logits, const long long* targets, const float* hist,
                             void* scratch, float* value, float* grad, const Pixels& px,
                             cudaStream_t s) {
  const int c = px.c;
  const long long plane = (long long)c * NB, nscale = scale_blocks(c);
  double* part = static_cast<double*>(scratch);                        // [nscale]
  float* table = reinterpret_cast<float*>(part + nscale);              // [c][NB]
  float* gts = table + plane;                                          // [c]
  logits_coef_classes<<<(c + WARPS - 1) / WARPS, THREADS, 0, s>>>(hist, c, table, gts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  logits_coef_scale<<<(int)nscale, THREADS, 0, s>>>(hist, c, table, gts, part);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  logits_value<<<1, THREADS, 0, s>>>(part, nscale, value);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int table_smem = (long long)c * NBP * 4 <= TABLE_SMEM;
  const int smem = table_smem ? c * NBP * 4 : 0;
  err = cudaFuncSetAttribute(logits_grad_wide<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const long long want = (px.p_len + ROW_WARPS * WARP_PIX - 1) / (ROW_WARPS * WARP_PIX);
  int blocks;
  if ((err = fill_blocks(logits_grad_wide<T>, ROW_THREADS, smem, want, &blocks)) != cudaSuccess)
    return err;
  logits_grad_wide<T><<<blocks, ROW_THREADS, smem, s>>>(static_cast<const T*>(logits), targets,
                                                        table, grad, px, table_smem);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// C entry points

// Histogram blocks for c classes of p_len pixels on a card with `sms` SMs.
// Up to MAXC classes: enough that RESIDENT of them fill every SM once, but
// no more than give each warp 4 tiles of 32 pixels, and never fewer than
// keep each block under BLOCK_PIXELS pixels (the exactness of its
// partials). Above: the pixel blocks of each class group, so that the
// groups' blocks (GROUP_RESIDENT on an SM) fill the SMs once, none takes
// fewer than 1024 pixels, and none more than GROUP_TILES tiles (its 32-bit
// words exact).
extern "C" int tpuseg_lovasz_logits_plan(int c, long long p_len, int sms, int* nblk) {
  if (c < 1 || p_len < 0 || sms < 1) return (int)cudaErrorInvalidValue;
  if (c > MAXC) {
    long long n = (long long)GROUP_RESIDENT * sms / groups_of(c);
    const long long most = (p_len + 1023) / 1024;
    const long long tiles = (p_len + 31) / 32;
    const long long least = (tiles + GROUP_TILES - 1) / GROUP_TILES;
    n = n < most ? n : most;
    n = n > least ? n : least;
    *nblk = (int)(n > 1 ? n : 1);
    return 0;
  }
  long long n = (long long)RESIDENT * sms;
  const long long most = (p_len + THREADS * 4 - 1) / (THREADS * 4);
  const long long least = (p_len + BLOCK_PIXELS - 1) / BLOCK_PIXELS;
  n = n < most ? n : most;
  n = n > least ? n : least;
  *nblk = (int)(n > 1 ? n : 1);
  return 0;
}

// The scratch bytes a wrapper allocates for c classes of p_len pixels and
// the plan's nblk: for the histograms (grad 0) the f32 partials
// [nblk, 3, c, 256] up to MAXC classes, else the stats [p_len] float2 and
// the 64-bit totals [3, c, 256]; for the gradient nothing up to MAXC
// classes, else the value's block shares (double), the table [c, 256] and
// the fg totals [c] (f32).
extern "C" int tpuseg_lovasz_logits_scratch(int c, long long p_len, int nblk, int grad,
                                            long long* bytes) {
  if (c < 1 || p_len < 0 || nblk < 1) return (int)cudaErrorInvalidValue;
  const long long plane = (long long)c * NB;
  if (c <= MAXC)
    *bytes = grad ? 0 : (long long)nblk * 3 * plane * 4;
  else
    *bytes = grad ? scale_blocks(c) * 8 + (plane + c) * 4 : p_len * 8 + 3 * plane * 8;
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
// and W dense, batch stride t_bstride; scratch: tpuseg_lovasz_logits_scratch
// bytes; hist: f32 [3, c, 256]. Launches the passes on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int tpuseg_lovasz_logits_histograms(const void* logits, const long long* targets,
                                               void* scratch, float* hist, int c,
                                               long long p_len, long long hw,
                                               long long t_bstride, int has_ignore,
                                               long long ignore, int nblk, int bf16,
                                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (c < 1 || nblk < 1) return (int)cudaErrorInvalidValue;
  const long long n = 3LL * c * NB;
  if (p_len == 0) return (int)cudaMemsetAsync(hist, 0, (size_t)n * 4, s);
  const Pixels px = make_pixels(c, p_len, hw, t_bstride, has_ignore, ignore);
  if (c > MAXC)
    return (int)(bf16 ? hist_wide<__nv_bfloat16>(logits, targets, scratch, hist, px, nblk, s)
                      : hist_wide<float>(logits, targets, scratch, hist, px, nblk, s));
  float* partial = static_cast<float*>(scratch);
  cudaError_t err;
  if (bf16)
    err = c <= 16 ? launch_hist<__nv_bfloat16, 16>(logits, targets, partial, px, nblk, s)
                  : launch_hist<__nv_bfloat16, MAXC>(logits, targets, partial, px, nblk, s);
  else
    err = c <= 16 ? launch_hist<float, 16>(logits, targets, partial, px, nblk, s)
                  : launch_hist<float, MAXC>(logits, targets, partial, px, nblk, s);
  if (err != cudaSuccess) return (int)err;
  logits_hist_reduce<<<(int)((n + 31) / 32), THREADS, 0, s>>>(partial, hist, (int)n, nblk);
  return (int)cudaGetLastError();
}

// logits, targets as above; hist: f32 [3, c, 256]; scratch:
// tpuseg_lovasz_logits_scratch bytes; value: f32 [1]; grad: f32 [p_len, c].
// Up to MAXC classes launches the gradient pass (nblk blocks), whose every
// block computes the coefficients and whose block 0 writes the value;
// above, the coefficient kernels and then the gradient pass, which fills
// the card once. On `stream`; returns cudaGetLastError() (0 on success).
extern "C" int tpuseg_lovasz_logits_grad(const void* logits, const long long* targets,
                                         const float* hist, void* scratch, float* value,
                                         float* grad, int c, long long p_len, long long hw,
                                         long long t_bstride, int has_ignore, long long ignore,
                                         int nblk, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (c < 1 || nblk < 1) return (int)cudaErrorInvalidValue;
  const Pixels px = make_pixels(c, p_len, hw, t_bstride, has_ignore, ignore);
  if (c > MAXC)
    return (int)(bf16 ? grad_wide<__nv_bfloat16>(logits, targets, hist, scratch, value, grad,
                                                   px, s)
                      : grad_wide<float>(logits, targets, hist, scratch, value, grad, px, s));
  cudaError_t err;
  if (bf16)
    err = c <= 16 ? launch_grad<__nv_bfloat16, 16>(logits, targets, hist, value, grad, px, nblk, s)
                  : launch_grad<__nv_bfloat16, MAXC>(logits, targets, hist, value, grad, px, nblk, s);
  else
    err = c <= 16 ? launch_grad<float, 16>(logits, targets, hist, value, grad, px, nblk, s)
                  : launch_grad<float, MAXC>(logits, targets, hist, value, grad, px, nblk, s);
  return (int)err;
}
