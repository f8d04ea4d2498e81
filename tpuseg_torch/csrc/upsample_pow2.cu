// The cascaded x2 bilinear upsample of NHWC feature maps and logits
// (2^L for L = 1..3 steps), and its gradient, as one kernel each.
//
// Replaces no TPU kernel: the JAX package upsamples with plain XLA
// (tpuseg/ops/resize.py: up_pow2_bilinear and upsample2x_bilinear, whose x2
// steps XLA fuses). The port's plain version (tpuseg_torch/ops/resize.py)
// gathers each pass's two taps with index_select, multiplies, adds, and
// materialises every pass in fp32; autograd scatters its gradient back
// with index_add into zero-filled tensors. At DeepLab's logits
// [32, 64, 128, 66] x4 that moved about 43 GB a training step, and the
// index_add alone took 13% of the step's device time. This pair exists to
// move each of those bytes once.
//
// Bound on the H100: memory. The forward must read x once and write the
// 4^L times larger output once (1.107 GB at DeepLab's x4: 0.33 ms at
// 3.35 TB/s); the backward must read as much gradient once and write x's
// size. Every level in between lives in shared memory.
//
// Function: the plain version's, bit for bit. For each x2 step (either
// align_corners), H then W, each output the sum of two products, each
// product and the sum rounded to fp32 on its own (__fmul_rn, __fadd_rn: no
// FMA), with the plain version's taps: tables of {lo, hi, float bits of
// 1 - frac, of frac} made by the wrapper from the float64 source positions
// (ops/upsample.py). bf16 inputs are widened, and each step's result is
// rounded to bf16, where the plain version's .to(x.dtype) rounds it.
//
// Both kernels: a CTA owns an image, a band of rows and a band of columns,
// with every channel or, where a pixel's channels are wide, a group of
// them (whole 128-byte lines); the wrapper picks the widest band whose
// shared memory lets 3 CTAs share an SM.
//
// Forward: bands of output rows and columns. For each level s < L a CTA
// keeps a ring of two rows of u_s (step s's output, rounded) over the
// columns its band reads, in fp32. Output rows are made in order; a
// level-s row is made when a row of level s+1 needs it, from the two
// level-(s-1) rows in the ring below (the H lerp is taken afresh for each
// of the W lerp's two columns: the same products, so the same bits).
// Level-0 rows are read from x; the last level goes straight to global
// memory, 16 bytes a store where the rows' alignment allows.
//
// Backward, in gather form: bands of input rows and columns. For each step
// s from L down to 1, the gradient of u_s (G_s) becomes T_s = W^T G_s
// (rows of level s, columns of level s-1, fp32) and then G_{s-1} = H^T T_s,
// rounded to the step's dtype where autograd's cast rounds it. Each
// transposed sum gathers the outputs whose lo (then hi) tap is this index,
// in ascending order, from +0: the footprint tables {lo_begin, lo_end,
// hi_begin, hi_end}; the two sums are then added, as autograd adds the two
// index_adds. Nothing is scattered: no atomics, no zero fill, each
// input-gradient element written once. T_s rows live in rings (as many
// slots as the widest footprint), G_s rows in a row buffer, and G_L rows
// are staged from global memory with 16-byte cp.async, two rows in flight
// while the current one is used. A sum has 1 to 4 terms; the plain version
// adds the same terms in index_add's order, so the two agree up to that
// order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

// Measured on the H100 at the cells' shapes: 256 threads a CTA both ways
// (512 and 1024 slowed the backward, whose rows are short phases between
// barriers); the forward held to registers for 3 CTAs an SM.
constexpr int THREADS = 256;
constexpr int FWD_MIN_BLOCKS = 3;
constexpr int BWD_THREADS = 256;
constexpr int MAX_LEVELS = 3;
constexpr int MAX_FOOT = 4;            // outputs a tap index gathers, per branch
constexpr int SMEM_MAX = 227 * 1024;
constexpr int STAGES = 3;              // backward: gradient rows staged at once

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float lerp_rn(float a, float wa, float b, float wb) {
  return __fadd_rn(__fmul_rn(a, wa), __fmul_rn(b, wb));
}

// v rounded to T, read back as fp32
template <typename T>
__device__ __forceinline__ float rounded(float v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
}

// 16 bytes of T from fp32 values, rounded as store_as rounds
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = u;
}

// The wrapper's table, per x2 step s = 1..L in this order: row taps
// [h0 << s], column taps [w0 << s] ({lo, hi, bits of 1 - frac, of frac}
// per output index), row footprints [h0 << (s-1)], column footprints
// [w0 << (s-1)] ({lo_begin, lo_end, hi_begin, hi_end} per input index: the
// outputs whose lo, and whose hi, is that index).
struct Tabs {
  const int4* tap_r[MAX_LEVELS + 1];
  const int4* tap_c[MAX_LEVELS + 1];
  const int4* fp_r[MAX_LEVELS + 1];
  const int4* fp_c[MAX_LEVELS + 1];
};

template <int L>
__device__ __forceinline__ Tabs tables(const int4* tab, int h0, int w0) {
  Tabs t;
  long long off = 0;
#pragma unroll
  for (int s = 1; s <= L; ++s) {
    t.tap_r[s] = tab + off;
    off += (long long)h0 << s;
    t.tap_c[s] = tab + off;
    off += (long long)w0 << s;
    t.fp_r[s] = tab + off;
    off += (long long)h0 << (s - 1);
    t.fp_c[s] = tab + off;
    off += (long long)w0 << (s - 1);
  }
  return t;
}

// The (column, channel) of a thread's flat elements tid, tid + step, ...
// of a [columns, c] span, carried from one to the next without a division.
struct Walk {
  int k, ch, dk, dch;
  Walk() = default;
  __device__ __forceinline__ Walk(int first, int step, int c)
      : k(first / c), ch(first % c), dk(step / c), dch(step % c) {}
  __device__ __forceinline__ void next(int c) {
    k += dk;
    ch += dch;
    if (ch >= c) {
      ch -= c;
      ++k;
    }
  }
};

struct FwdArgs {
  int h0, w0, c, cg, groups, tw, th, cbands, rbands;
  int nw[MAX_LEVELS];   // the most columns a band reads at level s < L
  int vec;              // 1: output rows take 16-byte stores
};

template <typename T, int L>
struct Fwd {
  const T* __restrict__ x;
  T* __restrict__ out;
  Tabs tb;
  int c, cg, g0, img, tid;    // channels: all, the CTA's group and its first
  int hl[L + 1], wl[L + 1];
  int cl[L + 1], cn[L + 1];   // the band's first column and column count per level
  float* ring[L];             // two rows of level s, [columns, cg], slot = row & 1
  int stride[L];
  int next[L];                // the next row of level s to make
  Walk walk, walk_vec;        // this thread's first element, and first of V, of a row

  // the value at (row of level S with H taps rt, column taps t, channel ch)
  // from the two rows a, b of level S-1 whose first column is `base`
  __device__ __forceinline__ float value(const float* a, const float* b, float wa, float wb,
                                         int4 t, int base, int ch) const {
    const int lo = (t.x - base) * cg + ch, hi = (t.y - base) * cg + ch;
    return lerp_rn(lerp_rn(a[lo], wa, b[lo], wb), __int_as_float(t.z),
                   lerp_rn(a[hi], wa, b[hi], wb), __int_as_float(t.w));
  }

  __device__ void load_row(int r) {
    const T* src = x + (((long long)img * hl[0] + r) * wl[0] + cl[0]) * c + g0;
    float* dst = ring[0] + (r & 1) * stride[0];
    const int n = cn[0] * cg;
    Walk w = walk;
    for (int e = tid; e < n; e += THREADS, w.next(cg)) dst[e] = to_f32(src[w.k * c + w.ch]);
  }

  // level S (1 <= S < L) row r into its ring
  template <int S>
  __device__ void make_row(int r) {
    const int4 rt = __ldg(tb.tap_r[S] + r);
    const float* a = ring[S - 1] + (rt.x & 1) * stride[S - 1];
    const float* b = ring[S - 1] + (rt.y & 1) * stride[S - 1];
    const float wa = __int_as_float(rt.z), wb = __int_as_float(rt.w);
    float* dst = ring[S] + (r & 1) * stride[S];
    const int n = cn[S] * cg, base = cl[S - 1];
    const int4* ct = tb.tap_c[S] + cl[S];
    Walk w = walk;
    for (int e = tid; e < n; e += THREADS, w.next(cg))
      dst[e] = rounded<T>(value(a, b, wa, wb, __ldg(ct + w.k), base, w.ch));
  }

  // level S rows through `row` made, with what they need below
  template <int S>
  __device__ void ensure(int row) {
    while (next[S] <= row) {
      const int r = next[S];
      if constexpr (S == 0) {
        load_row(r);
      } else {
        ensure<S - 1>(__ldg(tb.tap_r[S] + r).y);
        make_row<S>(r);
      }
      __syncthreads();
      ++next[S];
    }
  }

  // output row r (level L) into global memory
  __device__ void out_row(int r, bool vec) {
    const int4 rt = __ldg(tb.tap_r[L] + r);
    const float* a = ring[L - 1] + (rt.x & 1) * stride[L - 1];
    const float* b = ring[L - 1] + (rt.y & 1) * stride[L - 1];
    const float wa = __int_as_float(rt.z), wb = __int_as_float(rt.w);
    const int n = cn[L] * cg, base = cl[L - 1];
    const int4* ct = tb.tap_c[L] + cl[L];
    T* dst = out + (((long long)img * hl[L] + r) * wl[L] + cl[L]) * c + g0;
    if (vec) {
      // V consecutive elements a thread (they straddle two columns only
      // where one group holds every channel), stored as 16 bytes. Lane l
      // reads its elements in the order rotated by (l * V / 32) % V, so
      // that a warp's shared-memory reads of one element each fall in 32
      // banks (in order, lanes V words apart would share a bank V-fold);
      // the rotation is undone in registers.
      constexpr int V = 16 / sizeof(T);
      const int rot = ((tid & 31) * V / 32) & (V - 1);
      Walk w = walk_vec;
      for (int e = tid * V; e < n; e += THREADS * V, w.next(cg)) {
        const int4 t0 = __ldg(ct + w.k);
        const int4 t1 = w.k + 1 < cn[L] ? __ldg(ct + w.k + 1) : t0;
        float v[V];
#pragma unroll
        for (int s = 0; s < V; ++s) {
          const int ch = w.ch + ((s + rot) & (V - 1));
          v[s] = ch < cg ? value(a, b, wa, wb, t0, base, ch)
                         : value(a, b, wa, wb, t1, base, ch - cg);
        }
        // v[s] holds element (s + rot) % V: rotate right by rot
#pragma unroll
        for (int bit = 1; bit < V; bit <<= 1) {
          if (rot & bit) {
            float u[V];
#pragma unroll
            for (int i = 0; i < V; ++i) u[i] = v[(i - bit) & (V - 1)];
#pragma unroll
            for (int i = 0; i < V; ++i) v[i] = u[i];
          }
        }
        store16(dst + w.k * c + w.ch, v);
      }
    } else {
      Walk w = walk;
      for (int e = tid; e < n; e += THREADS, w.next(cg))
        store_as(dst + w.k * c + w.ch, value(a, b, wa, wb, __ldg(ct + w.k), base, w.ch));
    }
  }
};

// grid: images x row bands x channel groups x column bands (fastest),
// THREADS threads
template <typename T, int L>
__global__ void __launch_bounds__(THREADS, FWD_MIN_BLOCKS)
    upsample_pow2_kernel(const T* __restrict__ x, T* __restrict__ out,
                         const int4* __restrict__ tab, FwdArgs p) {
  extern __shared__ __align__(16) float smem[];
  Fwd<T, L> f;
  f.x = x;
  f.out = out;
  f.tb = tables<L>(tab, p.h0, p.w0);
  f.c = p.c;
  f.cg = p.cg;
  f.tid = threadIdx.x;
  f.walk = Walk(f.tid, THREADS, p.cg);
  f.walk_vec = Walk(f.tid * (16 / (int)sizeof(T)), THREADS * (16 / (int)sizeof(T)), p.cg);
  const int cb = blockIdx.x % p.cbands, rest = blockIdx.x / p.cbands;
  f.g0 = rest % p.groups * p.cg;
  const int rb = rest / p.groups % p.rbands;
  f.img = rest / p.groups / p.rbands;
#pragma unroll
  for (int s = 0; s <= L; ++s) {
    f.hl[s] = p.h0 << s;
    f.wl[s] = p.w0 << s;
  }
  f.cl[L] = cb * p.tw;
  f.cn[L] = min(p.tw, f.wl[L] - f.cl[L]);
  const int first = rb * p.th, last = min(first + p.th, f.hl[L]);
  int row = first;
#pragma unroll
  for (int s = L; s >= 1; --s) {
    const int lo = __ldg(f.tb.tap_c[s] + f.cl[s]).x;
    const int hi = __ldg(f.tb.tap_c[s] + f.cl[s] + f.cn[s] - 1).y;
    f.cl[s - 1] = lo;
    f.cn[s - 1] = hi - lo + 1;
    row = __ldg(f.tb.tap_r[s] + row).x;
    f.next[s - 1] = row;
  }
  float* at = smem;
#pragma unroll
  for (int s = 0; s < L; ++s) {
    f.ring[s] = at;
    f.stride[s] = p.nw[s] * p.cg;
    at += 2 * f.stride[s];
  }
  for (int r = first; r < last; ++r) {
    f.template ensure<L - 1>(__ldg(f.tb.tap_r[L] + r).y);
    f.out_row(r, p.vec != 0);
    __syncthreads();
  }
}

struct BwdArgs {
  int h0, w0, c, cg, groups, tw, th, cbands, rbands;
  int nw[MAX_LEVELS + 1];      // the most columns a band's gradient spans at level s
  int slots[MAX_LEVELS + 1];   // ring slots of T_s, s >= 1
  int stage;                   // elements of T in one staging buffer
  long long total;             // elements of the gradient
};

template <typename T, int L>
struct Bwd {
  static constexpr int V = 16 / sizeof(T);
  const T* __restrict__ g;
  Tabs tb;
  int c, cg, g0, img, tid;    // channels: all, the CTA's group and its first
  int hl[L + 1], wl[L + 1];
  int cl[L + 1], cn[L + 1];   // the band's first column and column count per level
  T* stage;                   // STAGES staging buffers of G_L rows, used in turn
  int stage_n;
  int first_l;                // the band's first G_L row
  float* rowbuf[L];           // a G_s row, 1 <= s < L
  float* ring[L + 1];         // T_s rows in slots[s] slots, used in turn
  int rstride[L + 1], slots[L + 1];
  int next[L + 1];            // the next T_s row to make
  int head[L + 1];            // and its slot
  Walk walk;                  // this thread's first element of a row
  int last;                   // the band's last G_L row
  long long total;

  __device__ __forceinline__ long long row_start(int i) const {
    return (((long long)img * hl[L] + i) * wl[L] + cl[L]) * c;
  }

  // issue the copies of G_L row i into its staging buffer, as one cp.async
  // group: with every channel, the row's whole 16-byte lines (4-byte words
  // in the gradient's last line); with a group, each column's
  // 16-byte-aligned run of cg channels
  __device__ void stage_row(int i) {
    const long long r0 = row_start(i);
    T* dst = stage + (i - first_l) % STAGES * stage_n;
    if (cg == c) {
      const long long la = r0 / V, lb = (r0 + (long long)cn[L] * c + V - 1) / V;
      for (long long q = la + tid; q < lb; q += BWD_THREADS) {
        T* d = dst + (q - la) * V;
        const T* s = g + q * V;
        if ((q + 1) * V <= total) {
          cp16(d, s);
        } else {
          for (int u = 0; q * V + u < total; u += 4 / (int)sizeof(T)) cp4(d + u, s + u);
        }
      }
    } else {
      const int lines = cg / V;
      for (int q = tid; q < cn[L] * lines; q += BWD_THREADS) {
        const int k = q / lines, u = (q - k * lines) * V;
        cp16(dst + k * cg + u, g + r0 + (long long)k * c + g0 + u);
      }
    }
    cp_async_commit();
  }

  // where staged row i's first element lies in its buffer
  __device__ __forceinline__ const T* staged(int i) const {
    return stage + (i - first_l) % STAGES * stage_n +
           (cg == c ? (int)(row_start(i) % V) : 0);
  }

  // T_S = W^T G_S of one row: src holds G_S over level-S columns from cl[S]
  template <int S, typename Src>
  __device__ void w_t(const Src* src, float* dst) {
    const int n = cn[S - 1] * cg, base = cl[S];
    const int4* fc = tb.fp_c[S] + cl[S - 1];
    const int4* tc = tb.tap_c[S];
    Walk w = walk;
    for (int e = tid; e < n; e += BWD_THREADS, w.next(cg)) {
      const int4 f = __ldg(fc + w.k);
      const Src* col = src + w.ch;
      // the terms' loads all issued before the ordered sums take them
      float lo = 0.f, hi = 0.f;
#pragma unroll
      for (int u = 0; u < MAX_FOOT; ++u) {
        const int j = f.x + u;
        if (j < f.y)
          lo = __fadd_rn(lo, __fmul_rn(to_f32(col[(j - base) * cg]),
                                       __int_as_float(__ldg(&tc[j].z))));
      }
#pragma unroll
      for (int u = 0; u < MAX_FOOT; ++u) {
        const int j = f.z + u;
        if (j < f.w)
          hi = __fadd_rn(hi, __fmul_rn(to_f32(col[(j - base) * cg]),
                                       __int_as_float(__ldg(&tc[j].w))));
      }
      dst[e] = __fadd_rn(lo, hi);
    }
  }

  // G_{S-1} = H^T T_S of the level-(S-1) row whose footprint is fr, rounded
  // to T, into dst: a row buffer (columns `stride` = cg apart) or the input
  // gradient's row (c apart)
  template <int S, typename Out>
  __device__ void h_t(int4 fr, Out* dst, int stride) {
    const float* plo[MAX_FOOT];
    const float* phi[MAX_FOOT];
    float wlo[MAX_FOOT], whi[MAX_FOOT];
    const int nlo = fr.y - fr.x, nhi = fr.w - fr.z;
#pragma unroll
    for (int u = 0; u < MAX_FOOT; ++u) {
      const int i = fr.x + min(u, max(nlo - 1, 0)), j = fr.z + min(u, max(nhi - 1, 0));
      plo[u] = ring[S] + slot<S>(i) * rstride[S];
      phi[u] = ring[S] + slot<S>(j) * rstride[S];
      wlo[u] = u < nlo ? __int_as_float(__ldg(&tb.tap_r[S][i].z)) : 0.f;
      whi[u] = u < nhi ? __int_as_float(__ldg(&tb.tap_r[S][j].w)) : 0.f;
    }
    const int n = cn[S - 1] * cg;
    Walk w = walk;
    for (int e = tid; e < n; e += BWD_THREADS, w.next(cg)) {
      float lo = 0.f, hi = 0.f;
#pragma unroll
      for (int u = 0; u < MAX_FOOT; ++u)
        if (u < nlo) lo = __fadd_rn(lo, __fmul_rn(plo[u][e], wlo[u]));
#pragma unroll
      for (int u = 0; u < MAX_FOOT; ++u)
        if (u < nhi) hi = __fadd_rn(hi, __fmul_rn(phi[u][e], whi[u]));
      store_as(dst + w.k * stride + w.ch, rounded<T>(__fadd_rn(lo, hi)));
    }
  }

  // the slot of resident T_S row i (one of the last slots[S] made)
  template <int S>
  __device__ __forceinline__ int slot(int i) const {
    const int k = head[S] - (next[S] - i);
    return k < 0 ? k + slots[S] : k;
  }

  // T_S row i (the next) into its ring slot, with what it needs
  template <int S>
  __device__ void make_t(int i) {
    float* dst = ring[S] + head[S] * rstride[S];
    if constexpr (S == L) {
      // STAGES - 1 rows in flight ahead of row i; past the band's last row
      // an empty group keeps the count
      if (i + STAGES - 1 <= last) {
        stage_row(i + STAGES - 1);
      } else {
        cp_async_commit();
      }
      cp_wait<STAGES - 1>();
      __syncthreads();
      w_t<S>(staged(i), dst);
    } else {
      const int4 fr = __ldg(tb.fp_r[S + 1] + i);
      ensure<S + 1>(fr.y);
      h_t<S + 1>(fr, rowbuf[S], cg);
      __syncthreads();
      w_t<S>(rowbuf[S], dst);
    }
    __syncthreads();
  }

  // T_S rows through end - 1 made
  template <int S>
  __device__ void ensure(int end) {
    while (next[S] < end) {
      make_t<S>(next[S]);
      ++next[S];
      if (++head[S] == slots[S]) head[S] = 0;
    }
  }
};

// grid: images x row bands x channel groups x column bands (fastest),
// BWD_THREADS threads
template <typename T, int L>
__global__ void __launch_bounds__(BWD_THREADS)
    upsample_pow2_grad_kernel(const T* __restrict__ g, T* __restrict__ dx,
                              const int4* __restrict__ tab, BwdArgs p) {
  extern __shared__ __align__(16) float smem[];
  Bwd<T, L> k;
  k.g = g;
  k.tb = tables<L>(tab, p.h0, p.w0);
  k.c = p.c;
  k.cg = p.cg;
  k.tid = threadIdx.x;
  k.walk = Walk(k.tid, BWD_THREADS, p.cg);
  k.total = p.total;
  const int cb = blockIdx.x % p.cbands, rest = blockIdx.x / p.cbands;
  k.g0 = rest % p.groups * p.cg;
  const int rb = rest / p.groups % p.rbands;
  k.img = rest / p.groups / p.rbands;
#pragma unroll
  for (int s = 0; s <= L; ++s) {
    k.hl[s] = p.h0 << s;
    k.wl[s] = p.w0 << s;
  }
  k.cl[0] = cb * p.tw;
  k.cn[0] = min(p.tw, p.w0 - k.cl[0]);
  const int r0 = rb * p.th, r1 = min(r0 + p.th, p.h0);
  int first = r0, lastrow = r1 - 1;
#pragma unroll
  for (int s = 1; s <= L; ++s) {
    const int4 f0 = __ldg(k.tb.fp_c[s] + k.cl[s - 1]);
    const int4 f1 = __ldg(k.tb.fp_c[s] + k.cl[s - 1] + k.cn[s - 1] - 1);
    k.cl[s] = f0.z;
    k.cn[s] = f1.y - f0.z;
    first = __ldg(k.tb.fp_r[s] + first).z;
    lastrow = __ldg(k.tb.fp_r[s] + lastrow).y - 1;
    k.next[s] = first;
    k.head[s] = 0;
  }
  k.last = lastrow;
  k.first_l = first;
  k.stage = reinterpret_cast<T*>(smem);
  k.stage_n = p.stage;
  float* at = reinterpret_cast<float*>(k.stage + STAGES * p.stage);
#pragma unroll
  for (int s = 1; s < L; ++s) {
    k.rowbuf[s] = at;
    at += p.nw[s] * p.cg;
  }
#pragma unroll
  for (int s = 1; s <= L; ++s) {
    k.ring[s] = at;
    k.rstride[s] = p.nw[s - 1] * p.cg;
    k.slots[s] = p.slots[s];
    at += p.slots[s] * k.rstride[s];
  }
  for (int i = 0; i < STAGES - 1; ++i) {
    if (first + i <= lastrow) {
      k.stage_row(first + i);
    } else {
      cp_async_commit();
    }
  }
  for (int r = r0; r < r1; ++r) {
    const int4 fr = __ldg(k.tb.fp_r[1] + r);
    k.template ensure<1>(fr.y);
    k.template h_t<1>(fr, dx + (((long long)k.img * p.h0 + r) * p.w0 + k.cl[0]) * p.c + k.g0,
                      p.c);
    __syncthreads();
  }
}

long long fwd_smem(const FwdArgs& p, int levels) {
  long long bytes = 0;
  for (int s = 0; s < levels; ++s) bytes += 2LL * p.nw[s] * p.cg * 4;
  return bytes;
}

long long bwd_smem(const BwdArgs& p, int levels, int item) {
  long long bytes = (long long)STAGES * p.stage * item;
  for (int s = 1; s < levels; ++s) bytes += (long long)p.nw[s] * p.cg * 4;
  for (int s = 1; s <= levels; ++s) bytes += (long long)p.slots[s] * p.nw[s - 1] * p.cg * 4;
  return bytes;
}

template <typename T, int L>
int launch_fwd(const T* x, T* out, const int4* tab, int b, FwdArgs p, cudaStream_t stream) {
  const long long smem = fwd_smem(p, L);
  const long long grid = (long long)b * p.rbands * p.groups * p.cbands;
  if (smem > SMEM_MAX || grid >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(upsample_pow2_kernel<T, L>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  upsample_pow2_kernel<T, L><<<(unsigned)grid, THREADS, (size_t)smem, stream>>>(x, out, tab, p);
  return (int)cudaGetLastError();
}

template <typename T, int L>
int launch_bwd(const T* g, T* dx, const int4* tab, int b, BwdArgs p, cudaStream_t stream) {
  const long long smem = bwd_smem(p, L, (int)sizeof(T));
  const long long grid = (long long)b * p.rbands * p.groups * p.cbands;
  if (smem > SMEM_MAX || grid >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(upsample_pow2_grad_kernel<T, L>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  upsample_pow2_grad_kernel<T, L><<<(unsigned)grid, BWD_THREADS, (size_t)smem, stream>>>(
      g, dx, tab, p);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd_levels(const void* x, void* out, const int4* tab, int b, int levels, const FwdArgs& p,
               cudaStream_t s) {
  const T* xi = (const T*)x;
  T* o = (T*)out;
  switch (levels) {
    case 1: return launch_fwd<T, 1>(xi, o, tab, b, p, s);
    case 2: return launch_fwd<T, 2>(xi, o, tab, b, p, s);
    case 3: return launch_fwd<T, 3>(xi, o, tab, b, p, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int bwd_levels(const void* g, void* dx, const int4* tab, int b, int levels, BwdArgs p,
               cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  p.stage = (p.nw[levels] * p.cg + 2 * V + V - 1) / V * V;
  const T* gi = (const T*)g;
  T* d = (T*)dx;
  switch (levels) {
    case 1: return launch_bwd<T, 1>(gi, d, tab, b, p, s);
    case 2: return launch_bwd<T, 2>(gi, d, tab, b, p, s);
    case 3: return launch_bwd<T, 3>(gi, d, tab, b, p, s);
  }
  return (int)cudaErrorInvalidValue;
}

// a group of cg channels: all of them, or a 16-byte-aligned share
bool bad_shape(int b, int h0, int w0, int c, int cg, int levels, int tw, int th, int v) {
  return b < 1 || h0 < 1 || w0 < 1 || c < 1 || levels < 1 || levels > MAX_LEVELS || tw < 1 ||
         th < 1 || (long long)h0 << levels > (1 << 24) || (long long)w0 << levels > (1 << 24) ||
         cg < 1 || c % cg != 0 || (cg != c && (cg % v != 0 || c % v != 0));
}

}  // namespace

// x [b, h0, w0, c] -> out [b, h0 << levels, w0 << levels, c], both
// contiguous, f32 or (bf16 nonzero) bf16, out 16-byte aligned. tab: the
// wrapper's table (see Tabs). cg channels, tw output columns and th output
// rows a CTA; nw0..nw2: the most columns a band reads at levels
// 0..levels-1. Launches on `stream`; returns a cudaError_t (0 on success).
extern "C" int tpuseg_upsample_pow2(const void* x, void* out, const int4* tab, int b, int h0,
                                    int w0, int c, int cg, int levels, int tw, int th, int nw0,
                                    int nw1, int nw2, int bf16, void* stream) {
  const int v = bf16 ? 8 : 4;
  if (bad_shape(b, h0, w0, c, cg, levels, tw, th, v) || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  FwdArgs p;
  p.h0 = h0;
  p.w0 = w0;
  p.c = c;
  p.cg = cg;
  p.groups = c / cg;
  p.tw = tw;
  p.th = th;
  p.cbands = ((w0 << levels) + tw - 1) / tw;
  p.rbands = ((h0 << levels) + th - 1) / th;
  p.nw[0] = nw0;
  p.nw[1] = nw1;
  p.nw[2] = nw2;
  p.vec = cg != c || (c >= v && (long long)(w0 << levels) * c % v == 0 &&
                      (long long)tw * c % v == 0);
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? fwd_levels<__nv_bfloat16>(x, out, tab, b, levels, p, s)
              : fwd_levels<float>(x, out, tab, b, levels, p, s);
}

// The gradient: g [b, h0 << levels, w0 << levels, c] -> dx [b, h0, w0, c],
// both contiguous, g 16-byte aligned. cg channels, tw input columns and th
// input rows a CTA; nw1..nw3: the most columns a band's gradient spans at
// levels 1..levels; slots1..slots3: the widest row footprint of steps
// 1..levels.
extern "C" int tpuseg_upsample_pow2_grad(const void* g, void* dx, const int4* tab, int b,
                                         int h0, int w0, int c, int cg, int levels, int tw,
                                         int th, int nw1, int nw2, int nw3, int slots1,
                                         int slots2, int slots3, int bf16, void* stream) {
  if (bad_shape(b, h0, w0, c, cg, levels, tw, th, bf16 ? 8 : 4) || ((uintptr_t)g & 15))
    return (int)cudaErrorInvalidValue;
  BwdArgs p;
  p.h0 = h0;
  p.w0 = w0;
  p.c = c;
  p.cg = cg;
  p.groups = c / cg;
  p.tw = tw;
  p.th = th;
  p.cbands = (w0 + tw - 1) / tw;
  p.rbands = (h0 + th - 1) / th;
  p.nw[0] = tw;
  p.nw[1] = nw1;
  p.nw[2] = nw2;
  p.nw[3] = nw3;
  p.slots[0] = 0;
  p.slots[1] = slots1;
  p.slots[2] = slots2;
  p.slots[3] = slots3;
  p.total = (long long)b * (h0 << levels) * (w0 << levels) * c;
  for (int s = 1; s <= levels; ++s)
    if (p.slots[s] < 1 || p.nw[s] < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? bwd_levels<__nv_bfloat16>(g, dx, tab, b, levels, p, s)
              : bwd_levels<float>(g, dx, tab, b, levels, p, s);
}

// The limits this library was compiled with, for the wrapper to hold its
// own copies to: out[0..3] = MAX_LEVELS, MAX_FOOT, STAGES, SMEM_MAX.
extern "C" int tpuseg_upsample_pow2_limits(int* out) {
  out[0] = MAX_LEVELS;
  out[1] = MAX_FOOT;
  out[2] = STAGES;
  out[3] = SMEM_MAX;
  return 0;
}
