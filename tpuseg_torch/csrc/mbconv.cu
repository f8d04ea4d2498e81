// Fused MobileNetV2 inverted-residual block (eval, BatchNorm folded), exact
// to fp32, with both 1x1 products on the tensor cores.
//
// Replaces the TPU kernel tpuseg/ops/pallas_mbconv.py:136
// fused_inverted_residual (body _mbconv_kernel, :76), whose function is
// mbconv_reference (:47):
//
//   y   = relu6(x @ we * se + be)                 (absent when we is null)
//   z   = relu6(dw3x3(pad1(y), wd, stride) * sd + bd)
//   out = z @ wp * sp + bp   (+ x when use_res)
//
// x f32 [B,H,W,Cin], we [Cin,hid] or null, wd [3,3,hid], wp [hid,Cout],
// per-channel affines se/be/sd/bd [hid] and sp/bp [Cout] -> out f32
// [B, H/s, W/s, Cout] (H/s and W/s rounded down, as the reference's
// ho = h // stride), all NHWC and contiguous. Neither hidden tensor (up to
// 6x the block's width) is ever written to device memory.
//
// Bound on the H100: operations. The encoder's 17 blocks at batch 8 and a
// 256x128 input do 2.81 GFLOP, 2.58 of them in the two 1x1 products,
// against about 39 MB of compulsory traffic (0.012 ms at 3.35 TB/s). This
// kernel's route: each 1x1 product term is 3 TF32 products (3xTF32, see
// sm90.cuh) at 495 TFLOP/s, the depthwise FMAs on the CUDA cores at
// 67 TFLOP/s: 0.022 ms over the 17 blocks, where the bytes bound a few of
// them (exact fp32 on the CUDA cores alone: 0.044 ms). In practice a block
// is paced by its CTAs' serial phases (staging, expand, depthwise, project,
// the cluster sum, each behind a barrier) on the few CTAs that its tiles
// give, and within the products by the instructions around each mma.sync
// (fragment loads and the operand splits), not by the tensor cores' rate.
//
// Design. One CTA computes a tile of output pixels of one image for up to
// CT output channels, over a range of the hidden channels: an 8x16 tile
// (M = 128) for the large images, two 4x16 tiles (M = 64) for an 8x16
// image, one 4x8 tile (M = 32) for a 4x8 one. The input patch
// ((TOH-1)s+3 x (TOW-1)s+3 pixels) is clipped to the image, and only its
// pixels inside the image are expanded: a pad pixel is a zero in the hidden
// patch, written once and never computed (the depthwise conv's zero
// padding; the mask at pallas_mbconv.py:93-103). A table of the clipped
// pixels' places in the patch is built once, so no loop divides. The x
// patch is staged once, with all its Cin channels, and the hidden channels
// are streamed through the CTA in chunks of HC = 32. For each chunk:
//   1. expand: the patch's [pixels x Cin] @ we[:, chunk] on the tensor
//      cores (3xTF32 m16n8k8 mma.sync, four independent chains per warp;
//      each k-step's three products chained on the tensor core from zero,
//      then added in round-to-nearest on the CUDA cores), then se, be and
//      ReLU6, into the hidden patch in shared memory;
//   2. depthwise 3x3 at stride s on the CUDA cores, each thread sliding
//      down one column of one channel with the rows in registers, then
//      sd, bd and ReLU6, into the depthwise tile [M x HC];
//   3. project: the tile @ wp[chunk, :] on the tensor cores (3xTF32, the
//      warp's n8 tiles in groups of 4, no product for a padding tile),
//      accumulated in registers across the chunks.
// The we and wp slices and the per-channel rows (wd, se, be, sd, bd) of
// chunk c+1 are in flight in a double-buffered ring while chunk c
// computes. Where every span is whole and 16-byte aligned (channel counts
// that are multiples of 8), a span of 128 bytes or more (an x pixel's
// channels, a weight row) is one bulk copy (the TMA unit) signalling the
// slot's mbarrier, and a shorter one goes by 16-byte cp.async: staged by
// cp.async alone the late blocks wait longer for their first chunk, and
// staged by bulk copies alone the early blocks' many short x pixels queue
// on the TMA unit. Elsewhere every span goes by cp.async, masked.
//
// Where the tiles are too few to fill the card, the hidden channels are
// split over a thread-block cluster of up to 16 CTAs. The split is the one
// whose grid the card finishes soonest by the occupancy API, which knows
// how clusters pack into the GPCs (tpuseg_mbconv_plan). Each CTA leaves its
// partial [M x CT] product in its shared memory, and each sums a share of
// the tile's rows over the cluster's CTAs through distributed shared
// memory, in rank order, then applies sp, bp and the residual:
// deterministic, no float atomics, no partial products in device memory,
// one launch.
//
// Every ragged edge (image, tile, Cin, hidden, Cout) is masked, so every
// shape the reference takes is taken: odd H or W at stride 2, channel
// counts off 8, batch 1, with no fallback. A Cout wider than one CTA's CT
// is split over CTAs (each recomputes the expand and the depthwise), and a
// Cin whose patch does not fit in shared memory is taken in pieces of kx
// channels, each staged in turn.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int HC = 32;                 // hidden channels per chunk
constexpr int HS = HC + 8;             // hidden patch and we slice row stride: conflict-free B loads
constexpr int DS = HC + 4;             // depthwise tile row stride: conflict-free A loads
constexpr int MAX_CLUSTER = 16;        // the largest cluster (above 8 where the card allows)
constexpr int SMEM_MAX = 232448;       // dynamic shared memory a block may use (227 KB)
constexpr int NPRM = 13;               // per-channel rows staged per chunk: wd (9), se, be, sd, bd
constexpr int BULK_MIN = 128;          // bytes: a staged span this long goes by one bulk copy

// tile configurations: output rows and columns; threads; n8 tiles per
// warp along Cout (in groups of up to 4 per branch); n8 tiles per expand
// item (NG < 4 runs 4 / NG k-steps at once instead); CTAs per SM the
// registers must allow. Configuration 1 runs two CTAs of 8 warps per SM,
// configuration 4 (the same tile) one CTA of 16 warps, for layouts too
// large for two.
constexpr int NCFG = 5;
constexpr int TILE_H[NCFG] = {4, 8, 8, 4, 8};
constexpr int TILE_W[NCFG] = {8, 16, 16, 16, 16};
constexpr int TILE_NT[NCFG] = {256, 256, 256, 256, 512};
constexpr int TILE_NTW[NCFG] = {12, 4, 12, 8, 2};
constexpr int TILE_NG[NCFG] = {1, 4, 4, 4, 4};
constexpr int TILE_MINB[NCFG] = {1, 2, 1, 1, 1};
constexpr int SMEM_SM = 233472;        // shared memory of one SM (228 KB)

template <int S, int K>
struct Cfg {
  static constexpr int TOH = TILE_H[K], TOW = TILE_W[K], NTW = TILE_NTW[K], NG = TILE_NG[K];
  static constexpr int NT = TILE_NT[K], NWARP = NT / 32;
  static constexpr int GJ = NTW < 4 ? NTW : 4;      // n8 tiles per project group
  static constexpr int M_OUT = TOH * TOW;
  static constexpr int WM = M_OUT / 16;             // warps along M: one m16 tile each
  static constexpr int WN = NWARP / WM;             // warps along Cout
  static constexpr int CT = NTW * 8 * WN;           // output channels per CTA
  static constexpr int PH = (TOH - 1) * S + 3, PW = (TOW - 1) * S + 3;
  static constexpr int P_IN = PH * PW;              // halo'd input patch pixels
  static_assert(M_OUT % 16 == 0 && WM * WN == NWARP && NTW % GJ == 0, "tile");
};

struct Args {
  const float *x, *we, *se, *be, *wd, *sd, *bd, *wp, *sp, *bp;
  float* out;
  int h, w, cin, hidden, cout, ho, wo, use_res;
  int tiles_w, tiles_hw, cout_tiles;
  int cs, per;                  // CTAs sharing a tile's hidden channels, channels each
  int kx, nkx;                  // Cin channels staged at once, pieces
  int vec_x, vec_we, vec_wp;    // 16-byte copies allowed
  int bulk;                     // stage by bulk copies (every span 16-byte aligned, whole)
  int wps, rs;                  // row strides: wp slice, partial tile
  int off_ring, stage, off_wp, off_prm, off_hs, off_ds, off_tab, off_bar;   // smem, in floats
};

__device__ __forceinline__ float relu6(float v) { return fminf(fmaxf(v, 0.f), 6.f); }

// 4 independent 3xTF32 products, issued product by product so that the
// tensor core has 4 chains in flight: d[s] += a[s / ASTEP] * b[s] for the
// slots s in the warp-uniform mask `live` (a dead slot's tile is padding)
template <int ASTEP>
__device__ __forceinline__ void mma4(float (&d)[4][4], const uint32_t (&ab)[4 / ASTEP][4],
                                     const uint32_t (&as)[4 / ASTEP][4], const uint32_t (&bb0)[4],
                                     const uint32_t (&bb1)[4], const uint32_t (&bs0)[4],
                                     const uint32_t (&bs1)[4], unsigned live) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
    if (live >> s & 1) mma_tf32_unordered(d[s], as[s / ASTEP], bb0[s], bb1[s]);
#pragma unroll
  for (int s = 0; s < 4; ++s)
    if (live >> s & 1) mma_tf32_unordered(d[s], ab[s / ASTEP], bs0[s], bs1[s]);
#pragma unroll
  for (int s = 0; s < 4; ++s)
    if (live >> s & 1) mma_tf32_unordered(d[s], ab[s / ASTEP], bb0[s], bb1[s]);
}

// the first n (at most G) of G independent 3xTF32 products with one A fragment:
// d[s] += a * b[s] (n is warp-uniform)
template <int G>
__device__ __forceinline__ void mma_g(float (&d)[G][4], const uint32_t (&ab)[4],
                                      const uint32_t (&as)[4], const uint32_t (&bb0)[G],
                                      const uint32_t (&bb1)[G], const uint32_t (&bs0)[G],
                                      const uint32_t (&bs1)[G], int n) {
#pragma unroll
  for (int s = 0; s < G; ++s)
    if (s < n) mma_tf32_unordered(d[s], as, bb0[s], bb1[s]);
#pragma unroll
  for (int s = 0; s < G; ++s)
    if (s < n) mma_tf32_unordered(d[s], ab, bs0[s], bs1[s]);
#pragma unroll
  for (int s = 0; s < G; ++s)
    if (s < n) mma_tf32_unordered(d[s], ab, bb0[s], bb1[s]);
}

template <int G>
__device__ __forceinline__ void flush4(float (&run)[G][4], float (&d)[G][4]) {
#pragma unroll
  for (int s = 0; s < G; ++s)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      run[s][q] += d[s][q];
      d[s][q] = 0.f;
    }
}

// f(row, col) for every row < rows and col < cols, spread over the block:
// a power-of-two group of lanes per row, so no thread divides
template <int NWARP, class F>
__device__ __forceinline__ void for_rows(int rows, int cols, F f) {
  int sh = 0;
  while ((1 << sh) < cols && sh < 5) ++sh;
  const int lane = threadIdx.x & 31, step = NWARP * (32 >> sh);
  const int c0 = lane & ((1 << sh) - 1);
  for (int r = (threadIdx.x >> 5) * (32 >> sh) + (lane >> sh); r < rows; r += step)
    for (int c = c0; c < cols; c += 1 << sh) f(r, c);
}

template <int S, int K>
__global__ void __launch_bounds__(TILE_NT[K], TILE_MINB[K]) mbconv_kernel(const Args a) {
  using C = Cfg<S, K>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  const int rank = blockIdx.x % a.cs, rest = blockIdx.x / a.cs;
  const int ctile = rest % a.cout_tiles, tile = rest / a.cout_tiles;
  const int img = tile / a.tiles_hw, th = tile % a.tiles_hw;
  const int oy0 = (th / a.tiles_w) * C::TOH, ox0 = (th % a.tiles_w) * C::TOW;
  const int iy0 = oy0 * S - 1, ix0 = ox0 * S - 1;     // patch origin in the image
  // the patch clipped to the image: patch rows py_lo.., columns px_lo..
  const int py_lo = iy0 < 0 ? -iy0 : 0, py_hi = min(C::PH, a.h - iy0);
  const int px_lo = ix0 < 0 ? -ix0 : 0, px_hi = min(C::PW, a.w - ix0);
  const int cw = px_hi - px_lo, m_in = (py_hi - py_lo) * cw;
  const int n0 = ctile * C::CT, ct = min(C::CT, a.cout - n0), nt_out = (ct + 7) / 8;
  const int hid0 = rank * a.per, hid1 = min(a.hidden, hid0 + a.per);
  const int nchunks = hid1 > hid0 ? (hid1 - hid0 + HC - 1) / HC : 0;
  const bool expand = a.we != nullptr;
  const float* xb = a.x + (long long)img * a.h * a.w * a.cin;
  const int xstride = a.kx + 4;
  float* xs = smem;                     // [m_in rounded to 16][kx + 4]: the clipped x patch
  float* ring = smem + a.off_ring;      // 2 x {we slice [kx][HS], wp slice [HC][wps]}
  float* hs = smem + a.off_hs;          // [P_IN][HS]: the hidden patch, 0 at pad pixels
  float* ds = smem + a.off_ds;          // [M_OUT][DS]: the depthwise tile
  int* ptab = reinterpret_cast<int*>(smem + a.off_tab);   // clipped pixel -> patch pixel

  // patch pixel pos: its offset in the image (PW is a constant: no division)
  auto image_pix = [&](int pos) {
    return (long long)(iy0 + pos / C::PW) * a.w + ix0 + pos % C::PW;
  };
  auto slot = [&](int ci) { return ring + (ci & 1) * a.stage; };

  auto stage_x = [&](int piece) {       // Cin channels piece*kx.. of the patch -> xs
    const int c0 = piece * a.kx, vw = a.vec_x ? 4 : 1;
    for_rows<C::NWARP>(m_in, a.kx / vw, [&](int r, int cq) {
      const int c = c0 + cq * vw;
      const bool ok = c < a.cin;
      const float* src = ok ? xb + image_pix(ptab[r]) * a.cin + c : a.x;
      if (vw == 4)
        cp_async16(xs + r * xstride + cq * 4, src, ok);
      else
        cp_async4(xs + r * xstride + cq, src, ok);
    });
  };
  auto stage_we = [&](int ci, int piece, float* dst) {   // we[piece rows, chunk ci] -> [kx][HS]
    const int hc = hid0 + ci * HC, kc = min(HC, hid1 - hc), c0 = piece * a.kx;
    const int vw = a.vec_we ? 4 : 1;
    for_rows<C::NWARP>(a.kx, HC / vw, [&](int k, int jq) {
      const int j = jq * vw, c = c0 + k;
      const bool ok = c < a.cin && j < kc;
      const float* src = ok ? a.we + (long long)c * a.hidden + hc + j : a.we;
      if (vw == 4)
        cp_async16(dst + k * HS + j, src, ok);
      else
        cp_async4(dst + k * HS + j, src, ok);
    });
  };
  auto stage_wp = [&](int ci, float* dst) {   // wp[chunk ci, n0..n0+ct) -> [HC][wps]
    const int hc = hid0 + ci * HC, kc = min(HC, hid1 - hc);
    const int vw = a.vec_wp ? 4 : 1;
    for_rows<C::NWARP>(HC, nt_out * 8 / vw, [&](int k, int jq) {
      const int j = jq * vw;
      const bool ok = k < kc && j < ct;
      const float* src = ok ? a.wp + (long long)(hc + k) * a.cout + n0 + j : a.wp;
      if (vw == 4)
        cp_async16(dst + k * a.wps + j, src, ok);
      else
        cp_async4(dst + k * a.wps + j, src, ok);
    });
  };

  auto stage_prm = [&](int ci, float* dst) {   // wd, se, be, sd, bd of chunk ci -> [NPRM][HC]
    const int hc = hid0 + ci * HC, kc = min(HC, hid1 - hc);
    for (int e = tid; e < NPRM * HC; e += C::NT) {
      const int row = e / HC, j = e % HC;
      const float* base = row < 9    ? a.wd + (long long)row * a.hidden
                          : row == 9  ? a.se
                          : row == 10 ? a.be
                          : row == 11 ? a.sd
                                      : a.bd;
      const bool ok = j < kc && (expand || row < 9 || row > 10);
      cp_async4(dst + e, ok ? base + hc + j : a.wd, ok);
    }
  };

  // the same where every span is whole and 16-byte aligned (Cin, hidden and
  // Cout multiples of 8, so nothing is masked): x (with chunk 0), we, wp and
  // the per-channel rows of chunk ci. A span of BULK_MIN bytes or more is
  // one bulk copy that signals the slot's mbarrier; a shorter one (an x
  // pixel of fewer than 32 channels, say) goes by 16-byte cp.async, as the
  // TMA unit takes many short copies more slowly than the load pipe.
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + a.off_bar);
  auto stage_bulk = [&](int ci, bool with_x) {
    const int hc = hid0 + ci * HC, kc = min(HC, hid1 - hc);
    float* dst = slot(ci);
    uint64_t* bar = bars + (ci & 1);
    // spans: nx x pixels (cin floats), cin we rows (kc), kc wp rows (ct),
    // NPRM per-channel rows (kc)
    const int nx = with_x ? m_in : 0, n_we = nx + a.cin, n_wp = n_we + kc;
    const int n_all = n_wp + NPRM;
    auto span = [&](int e, float*& d, const float*& s, int& len) {
      if (e < nx) {
        d = xs + e * xstride;
        s = xb + image_pix(ptab[e]) * a.cin;
        len = a.cin;
      } else if (e < n_we) {
        const int k = e - nx;
        d = dst + k * HS;
        s = a.we + (long long)k * a.hidden + hc;
        len = kc;
      } else if (e < n_wp) {
        const int k = e - n_we;
        d = dst + a.off_wp + k * a.wps;
        s = a.wp + (long long)(hc + k) * a.cout + n0;
        len = ct;
      } else {
        const int row = e - n_wp;
        d = dst + a.off_prm + row * HC;
        s = (row < 9    ? a.wd + (long long)row * a.hidden
             : row == 9  ? a.se
             : row == 10 ? a.be
             : row == 11 ? a.sd
                         : a.bd) + hc;
        len = kc;
      }
    };
    const bool long_x = 4 * a.cin >= BULK_MIN, long_k = 4 * kc >= BULK_MIN;
    const bool long_wp = 4 * ct >= BULK_MIN;
    if (tid == 0) {                             // the bytes of the long spans
      mbar_arrive_expect(bar, 4u * ((long_x ? nx * a.cin : 0) + (long_k ? (a.cin + NPRM) * kc : 0) +
                                    (long_wp ? kc * ct : 0)));
    }
    // the long spans, one thread each
    for (int e = tid; e < n_all; e += C::NT) {
      float* d;
      const float* s;
      int len;
      span(e, d, s, len);
      if (4 * len >= BULK_MIN) bulk_copy(d, s, 4u * len, bar);
    }
    // the short ones (under 32 floats), 16 bytes a thread
    const bool any_short = (nx > 0 && !long_x) || !long_k || !long_wp;
    for (int e = tid; any_short && e < n_all * 8; e += C::NT) {
      float* d;
      const float* s;
      int len;
      span(e / 8, d, s, len);
      const int q = 4 * (e % 8);
      if (4 * len < BULK_MIN && q < len) cp_async16(d + q, s + q, true);
    }
  };

  // prologue: the pad pixels of the hidden patch are 0 for good; the
  // clipped pixels' table; then the x patch and chunk 0's weights start loading
  for (int i = tid * 4; i < C::P_IN * HS; i += C::NT * 4)
    *reinterpret_cast<float4*>(hs + i) = make_float4(0.f, 0.f, 0.f, 0.f);
  for_rows<C::NWARP>(py_hi - py_lo, cw, [&](int ry, int rx) {
    ptab[ry * cw + rx] = (py_lo + ry) * C::PW + px_lo + rx;
  });
  if (tid == 0 && a.bulk) {
    mbar_init(bars, 1);
    mbar_init(bars + 1, 1);
  }
  __syncthreads();
  const bool x_once = expand && a.nkx == 1;
  if (nchunks > 0 && a.bulk) {
    stage_bulk(0, true);
  } else if (nchunks > 0) {
    if (x_once) stage_x(0);
    if (x_once) stage_we(0, 0, slot(0));
    stage_wp(0, slot(0) + a.off_wp);
    stage_prm(0, slot(0) + a.off_prm);
  }
  cp_async_commit();

  const int mt = warp % C::WM, wn = warp / C::WM;   // the warp's project tile row and column
  constexpr int GJ = C::GJ;
  float prun[C::NTW / GJ][GJ][4], pd[C::NTW / GJ][GJ][4];   // n8 tile j: [j / GJ][j % GJ]
#pragma unroll
  for (int j = 0; j < C::NTW; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) prun[j / GJ][j % GJ][q] = pd[j / GJ][j % GJ][q] = 0.f;

  for (int ci = 0; ci < nchunks; ++ci) {
    const int hc = hid0 + ci * HC, kc = min(HC, hid1 - hc), ks_n = (kc + 7) / 8;
    float* st = slot(ci);
    cp_async_wait_all();
    if (a.bulk) mbar_wait(bars + (ci & 1), (ci >> 1) & 1);
    __syncthreads();              // chunk ci has landed; chunk ci-1 is done with the other slot
    if (ci + 1 < nchunks && a.bulk) {
      stage_bulk(ci + 1, false);
    } else if (ci + 1 < nchunks) {
      if (x_once) stage_we(ci + 1, 0, slot(ci + 1));
      stage_wp(ci + 1, slot(ci + 1) + a.off_wp);
      stage_prm(ci + 1, slot(ci + 1) + a.off_prm);
    }
    cp_async_commit();

    if (expand) {
      // 1. expand the patch's pixels inside the image: warp items of one m16
      //    tile x NG n8 tiles. Each item runs 4 slots of products at once:
      //    slot s is n8 tile s % NG at k-step offset s / NG (4 chains in flight).
      constexpr int NG = C::NG, KS = 4 / NG;
      const int nt_n = ks_n, mt_n = (m_in + 15) / 16, groups = (nt_n + NG - 1) / NG;
      for (int p = 0; p < a.nkx; ++p) {
        if (!x_once) {            // Cin in pieces: stage this piece's x and we
          __syncthreads();
          stage_x(p);
          stage_we(ci, p, st);
          cp_async_commit();
          cp_async_wait_all();
          __syncthreads();
        }
        const int kw_steps = min(a.kx, (a.cin + 7) / 8 * 8 - p * a.kx) / 8;
        const bool last = p == a.nkx - 1;
        for (int item = warp; item < mt_n * groups; item += C::NWARP) {
          const int em = item / groups, j0 = (item % groups) * NG;
          float run[4][4], d[4][4];
#pragma unroll
          for (int sl = 0; sl < 4; ++sl)
#pragma unroll
            for (int q = 0; q < 4; ++q) run[sl][q] = d[sl][q] = 0.f;
          for (int ks = 0; ks < kw_steps; ks += KS) {
            uint32_t ab[KS][4], as[KS][4], bb0[4], bs0[4], bb1[4], bs1[4];
#pragma unroll
            for (int kk = 0; kk < KS; ++kk) {
              const float* pa = xs + (em * 16 + g) * xstride + (ks + kk) * 8 + t;
              float v[4] = {0.f, 0.f, 0.f, 0.f};
              if (ks + kk < kw_steps) {
                v[0] = pa[0];
                v[1] = pa[8 * xstride];
                v[2] = pa[4];
                v[3] = pa[8 * xstride + 4];
              }
#pragma unroll
              for (int q = 0; q < 4; ++q) split_tf32_rn(v[q], ab[kk][q], as[kk][q]);
            }
#pragma unroll
            for (int sl = 0; sl < 4; ++sl) {
              const int jj = sl % NG, kk = sl / NG;
              const float* pb = st + ((ks + kk) * 8 + t) * HS + (j0 + jj) * 8 + g;
              float v0 = 0.f, v1 = 0.f;
              if (ks + kk < kw_steps && j0 + jj < nt_n) {
                v0 = pb[0];
                v1 = pb[4 * HS];
              }
              split_tf32_rn(v0, bb0[sl], bs0[sl]);
              split_tf32_rn(v1, bb1[sl], bs1[sl]);
            }
            unsigned live = 0;
#pragma unroll
            for (int sl = 0; sl < 4; ++sl)
              live |= (unsigned)(ks + sl / NG < kw_steps && j0 + sl % NG < nt_n) << sl;
            mma4<NG>(d, ab, as, bb0, bb1, bs0, bs1, live);
            flush4(run, d);       // each k-step's short sum, added in round-to-nearest
          }
          // the slots of one n8 tile summed in slot order
#pragma unroll
          for (int sl = NG; sl < 4; ++sl)
#pragma unroll
            for (int q = 0; q < 4; ++q) run[sl % NG][q] += run[sl][q];
          // rows g, g+8 of the m16 tile are clipped patch pixels; columns
          // 2t, 2t+1 of each n8 tile hidden channels
#pragma unroll
          for (int jj = 0; jj < NG; ++jj) {
            if (j0 + jj >= nt_n) continue;
            const int o = hc + (j0 + jj) * 8 + 2 * t;
            // se, be of the chunk: 0 past hid1
            const float* pr = st + a.off_prm + (o - hc);
            const float s0 = pr[9 * HC], s1 = pr[9 * HC + 1];
            const float b0 = pr[10 * HC], b1 = pr[10 * HC + 1];
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int r = em * 16 + g + 8 * hf;
              if (r >= m_in) continue;
              float* dst = hs + ptab[r] * HS + (j0 + jj) * 8 + 2 * t;
              float v0 = run[jj][2 * hf], v1 = run[jj][2 * hf + 1];
              if (p > 0) {
                v0 += dst[0];
                v1 += dst[1];
              }
              if (last) {             // pad channels past hid1 get 0 * v + 0
                v0 = relu6(v0 * s0 + b0);
                v1 = relu6(v1 * s1 + b1);
              }
              dst[0] = v0;
              dst[1] = v1;
            }
          }
        }
      }
    } else {
      // no expand (expand ratio 1): the hidden chunk is x's channels hc..
      const int vw = a.vec_x ? 4 : 1;
      for_rows<C::NWARP>(m_in, HC / vw, [&](int r, int jq) {
        const int j = jq * vw;
        const bool ok = j < kc;
        const float* src = ok ? xb + image_pix(ptab[r]) * a.cin + hc + j : a.x;
        if (vw == 4)
          cp_async16(hs + ptab[r] * HS + j, src, ok);
        else
          cp_async4(hs + ptab[r] * HS + j, src, ok);
      });
      cp_async_commit();
      cp_async_wait_all();
    }
    __syncthreads();              // the hidden patch of chunk ci is whole

    // 2. depthwise 3x3 at stride S: lane = hidden channel, each warp slides
    //    down tile columns warp, warp + 8, ... with three patch rows in registers
    {
      const int j = lane;
      const bool live = j < kc;
      const float* pr = st + a.off_prm + j;   // 0 past hid1
      float wk[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) wk[k] = pr[k * HC];
      const float s_d = pr[11 * HC], b_d = pr[12 * HC];
      for (int col = warp; col < C::TOW; col += C::NWARP) {
        const float* base = hs + col * S * HS + j;
        float r0[3], r1[3], r2[3];
        auto load_row = [&](int py, float(&r)[3]) {
          const float* q = base + py * C::PW * HS;
          r[0] = q[0];
          r[1] = q[HS];
          r[2] = q[2 * HS];
        };
        load_row(0, r0);
        if (S == 1) load_row(1, r1);
#pragma unroll
        for (int ty = 0; ty < C::TOH; ++ty) {
          if (S == 2) load_row(2 * ty + 1, r1);
          load_row(ty * S + 2, r2);
          float acc = 0.f;
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) acc = fmaf(r0[dx], wk[dx], acc);
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) acc = fmaf(r1[dx], wk[3 + dx], acc);
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) acc = fmaf(r2[dx], wk[6 + dx], acc);
          ds[(ty * C::TOW + col) * DS + j] = live ? relu6(acc * s_d + b_d) : 0.f;
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            if (S == 1) {
              r0[dx] = r1[dx];
              r1[dx] = r2[dx];
            } else {
              r0[dx] = r2[dx];
            }
          }
        }
      }
    }
    __syncthreads();              // the depthwise tile is whole

    // 3. project: this chunk's [M x HC] @ wp slice [HC x CT], into prun,
    //    the warp's n8 tiles in groups of GJ (GJ chains in flight)
    const float* wb = st + a.off_wp;
    for (int ks = 0; ks < ks_n; ++ks) {
      uint32_t ab[4], as[4];
      const float* pa = ds + (mt * 16 + g) * DS + ks * 8 + t;
      split_tf32_rn(pa[0], ab[0], as[0]);
      split_tf32_rn(pa[8 * DS], ab[1], as[1]);
      split_tf32_rn(pa[4], ab[2], as[2]);
      split_tf32_rn(pa[8 * DS + 4], ab[3], as[3]);
      const float* pb = wb + (ks * 8 + t) * a.wps + g;
#pragma unroll
      for (int jb = 0; jb < C::NTW / GJ; ++jb) {
        if (wn + C::WN * GJ * jb >= nt_out) break;
        uint32_t bb0[GJ], bs0[GJ], bb1[GJ], bs1[GJ];
#pragma unroll
        for (int j = 0; j < GJ; ++j) {
          const int nt = wn + C::WN * (GJ * jb + j);
          float v0 = 0.f, v1 = 0.f;
          if (nt < nt_out) {
            v0 = pb[nt * 8];
            v1 = pb[nt * 8 + 4 * a.wps];
          }
          split_tf32_rn(v0, bb0[j], bs0[j]);
          split_tf32_rn(v1, bb1[j], bs1[j]);
        }
        mma_g<GJ>(pd[jb], ab, as, bb0, bb1, bs0, bs1,
                  (nt_out - wn - C::WN * GJ * jb + C::WN - 1) / C::WN);
      }
#pragma unroll
      for (int jb = 0; jb < C::NTW / GJ; ++jb) flush4(prun[jb], pd[jb]);
    }
  }

  // epilogue: prun[j] holds rows g, g+8 of tile row mt, columns 2t, 2t+1
  // of n8 tile wn + WN*j
  if (a.cs == 1) {
#pragma unroll
    for (int j = 0; j < C::NTW; ++j) {
      const int c = (wn + C::WN * j) * 8 + 2 * t;
      if (c >= ct) continue;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = mt * 16 + g + 8 * hf;
        const int oy = oy0 + r / C::TOW, ox = ox0 + r % C::TOW;
        if (oy >= a.ho || ox >= a.wo) continue;
        const long long pix = ((long long)img * a.ho + oy) * a.wo + ox;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + c + e;
          if (c + e >= ct) break;
          float v = prun[j / GJ][j % GJ][2 * hf + e] * __ldg(a.sp + n) + __ldg(a.bp + n);
          if (a.use_res) v += __ldg(a.x + pix * a.cin + n);
          a.out[pix * a.cout + n] = v;
        }
      }
    }
    return;
  }

  // a cluster: each CTA's partial tile goes to its own shared memory, and
  // each sums its share of the tile's rows over the cluster's CTAs in rank
  // order
  cp_async_wait_all();
  __syncthreads();                // every warp is done with the ring and the tiles
  float* red = smem;              // [M_OUT][rs]
#pragma unroll
  for (int j = 0; j < C::NTW; ++j) {
    const int c = (wn + C::WN * j) * 8 + 2 * t;
    if (c >= nt_out * 8) continue;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float* dst = red + (mt * 16 + g + 8 * hf) * a.rs + c;
      dst[0] = prun[j / GJ][j % GJ][2 * hf];
      dst[1] = prun[j / GJ][j % GJ][2 * hf + 1];
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int r0 = C::M_OUT * rank / a.cs, r1 = C::M_OUT * (rank + 1) / a.cs;
  const int vw = (ct & 3) == 0 ? 4 : 1;
  for_rows<C::NWARP>(r1 - r0, ct / vw, [&](int rr, int cq) {
    const int r = r0 + rr, c = cq * vw;
    const int oy = oy0 + r / C::TOW, ox = ox0 + r % C::TOW;
    if (oy >= a.ho || ox >= a.wo) return;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    for (int q = 0; q < a.cs; ++q) {
      const float* src = cluster.map_shared_rank(red, q) + r * a.rs + c;
      if (vw == 4) {
        const float4 f = *reinterpret_cast<const float4*>(src);
        v[0] += f.x;
        v[1] += f.y;
        v[2] += f.z;
        v[3] += f.w;
      } else {
        v[0] += src[0];
      }
    }
    const long long pix = ((long long)img * a.ho + oy) * a.wo + ox;
    for (int e = 0; e < vw; ++e) {
      const int n = n0 + c + e;
      float o = v[e] * __ldg(a.sp + n) + __ldg(a.bp + n);
      if (a.use_res) o += __ldg(a.x + pix * a.cin + n);
      a.out[pix * a.cout + n] = o;
    }
  });
  cluster.sync();                 // no CTA leaves while another reads its tile
}

// ---------------------------------------------------------------------------
// host side: the plan (tile, split, staging) and the launch

struct Plan {
  int k;                        // tile configuration (TILE_*)
  int tiles_w, tiles_hw, tiles, cout_tiles;
  int cs, per, kx, nkx, wps, rs;
  int off_ring, stage, off_wp, off_prm, off_hs, off_ds, off_tab, off_bar;
  int smem;                     // bytes
};

int round_up(int v, int m) { return (v + m - 1) / m * m; }

// the tile, the staging and the shared-memory layout for these sizes; false
// if no layout fits
bool make_plan(int b, int h, int w, int cin, int hidden, int cout, int stride, bool expand,
               Plan* p) {
  const int ho = h / stride, wo = w / stride;
  // a whole small image per tile (4x8, or 8x16 in two 4x16 tiles), else 8x16
  p->k = (ho <= TILE_H[0] && wo <= TILE_W[0]) ? 0
         : (ho <= 2 * TILE_H[3] && wo <= TILE_W[3]) ? 3
         : (cout <= 32 ? 1 : 2);
  const int toh = TILE_H[p->k], tow = TILE_W[p->k], m_out = toh * tow;
  const int ct_full = TILE_NTW[p->k] * 8 * (TILE_NT[p->k] / 32 / (m_out / 16));
  const int ph = (toh - 1) * stride + 3, pw = (tow - 1) * stride + 3, p_in = ph * pw;
  p->tiles_w = (wo + tow - 1) / tow;
  p->tiles_hw = ((ho + toh - 1) / toh) * p->tiles_w;
  p->tiles = b * p->tiles_hw;
  p->cout_tiles = (cout + ct_full - 1) / ct_full;
  const int cols = round_up(cout < ct_full ? cout : ct_full, 8);
  p->wps = cols;                // wp slice stride = 8 or 24 mod 32: conflict-free B loads
  while (p->wps % 32 != 8 && p->wps % 32 != 24) p->wps += 8;
  p->rs = cols + 4;
  // the widest Cin piece whose layout fits
  for (p->kx = expand ? round_up(cin, 8) : 8; p->kx >= 8; p->kx -= 8) {
    const int xs = expand ? round_up(p_in, 16) * (p->kx + 4) : 0;
    const int we = expand ? p->kx * HS : 0;
    p->off_wp = we;
    p->off_prm = we + HC * p->wps;
    p->stage = round_up(p->off_prm + NPRM * HC, 4);
    p->off_ring = xs;
    p->off_hs = p->off_ring + 2 * p->stage;
    p->off_ds = p->off_hs + p_in * HS;
    p->off_tab = p->off_ds + m_out * DS;
    const int end = p->off_tab + round_up(p_in, 4), red = m_out * p->rs;
    p->off_bar = end > red ? end : red;   // two mbarriers, past all else
    p->smem = 4 * (p->off_bar + 4);
    if (p->smem <= SMEM_MAX) break;
  }
  if (p->kx < 8) return false;
  p->nkx = expand ? (cin + p->kx - 1) / p->kx : 1;
  if (p->k == 1 && 2 * p->smem > SMEM_SM) p->k = 4;   // one CTA per SM: 16 warps
  return true;
}

// How many CTAs of this kernel the card runs at once in clusters of cs
// (cs = 1: no cluster), from the occupancy API; 0 if it runs none
template <int S, int K>
int concurrent(int cs, int smem, int sms) {
  auto kernel = mbconv_kernel<S, K>;
  int n = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
      cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  if (cs == 1) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, TILE_NT[K], smem) !=
        cudaSuccess)
      n = 0;
    cudaGetLastError();
    return n * sms;
  }
  cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, cs > 8);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs);
  cfg.blockDim = dim3(TILE_NT[K]);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) n = 0;
  cudaGetLastError();           // a refused cluster size is an answer, not an error
  return n * cs;
}

template <int S>
int concurrent_k(int k, int cs, int smem, int sms) {
  switch (k) {
    case 0: return concurrent<S, 0>(cs, smem, sms);
    case 1: return concurrent<S, 1>(cs, smem, sms);
    case 2: return concurrent<S, 2>(cs, smem, sms);
    case 3: return concurrent<S, 3>(cs, smem, sms);
    default: return concurrent<S, 4>(cs, smem, sms);
  }
}

// The split of the hidden channels over a cluster of cs CTAs per tile:
// the cs whose grid the card finishes soonest, counting waves of the CTAs
// it runs at once (the occupancy API, which knows the registers, the
// shared memory and how clusters pack into the GPCs) times each CTA's
// work (its chunks plus about 1.5 chunks of prologue and epilogue).
// Each CTA keeps 16 hidden channels or more.
void split_plan(int hidden, int stride, int sms, Plan* p) {
  const long long ctas = (long long)p->tiles * p->cout_tiles;
  long long best = -1;
  p->cs = 1;
  p->per = round_up(hidden, 8);
  for (int cs = 1; cs <= MAX_CLUSTER; ++cs) {
    if (cs > 1 && hidden < 16 * cs) break;
    const int per = round_up((hidden + cs - 1) / cs, 8);
    if ((hidden + per - 1) / per != cs) continue;
    const int conc = stride == 1 ? concurrent_k<1>(p->k, cs, p->smem, sms)
                                 : concurrent_k<2>(p->k, cs, p->smem, sms);
    if (conc < cs) continue;
    const long long waves = (ctas * cs + conc - 1) / conc;
    const long long cost = waves * (3 + 2 * ((per + HC - 1) / HC));
    if (best < 0 || cost < best) {
      best = cost;
      p->cs = cs;
      p->per = per;
    }
  }
}

template <int S, int K>
int launch(const Args& a, long long grid, int smem, cudaStream_t stream) {
  auto kernel = mbconv_kernel<S, K>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (a.cs == 1) {
    kernel<<<(unsigned)grid, TILE_NT[K], smem, stream>>>(a);
    return (int)cudaGetLastError();
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, a.cs > 8);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(TILE_NT[K]);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int S>
int launch_k(int k, const Args& a, long long grid, int smem, cudaStream_t stream) {
  switch (k) {
    case 0: return launch<S, 0>(a, grid, smem, stream);
    case 1: return launch<S, 1>(a, grid, smem, stream);
    case 2: return launch<S, 2>(a, grid, smem, stream);
    case 3: return launch<S, 3>(a, grid, smem, stream);
    default: return launch<S, 4>(a, grid, smem, stream);
  }
}

}  // namespace

// How tpuseg_mbconv splits the hidden channels for these sizes on a card
// with `sms` SMs: *splits CTAs (one thread-block cluster) share each output
// tile, each taking *per hidden channels (a multiple of 8). Returns a
// cudaError_t.
extern "C" int tpuseg_mbconv_plan(int b, int h, int w, int cin, int hidden, int cout,
                                  int stride, int expand, int sms, int* splits, int* per) {
  Plan p;
  if ((stride != 1 && stride != 2) || sms < 1 || b < 1 || cin < 1 || hidden < 1 || cout < 1 ||
      h / stride < 1 || w / stride < 1 || !make_plan(b, h, w, cin, hidden, cout, stride,
                                                     expand != 0, &p))
    return (int)cudaErrorInvalidValue;
  split_plan(hidden, stride, sms, &p);
  *splits = p.cs;
  *per = p.per;
  return 0;
}

// Launches on `stream`; returns a cudaError_t (0 on success). `we`, `se` and
// `be` are null for a block without expand.
extern "C" int tpuseg_mbconv(const float* x, const float* we, const float* se,
                             const float* be, const float* wd, const float* sd,
                             const float* bd, const float* wp, const float* sp,
                             const float* bp, float* out, int b, int h, int w, int cin,
                             int hidden, int cout, int stride, int use_res, int sms,
                             void* stream) {
  if ((stride != 1 && stride != 2) || sms < 1 || (we == nullptr && cin != hidden) ||
      (use_res && (stride != 1 || cin != cout)))
    return (int)cudaErrorInvalidValue;
  if (b == 0 || h / stride == 0 || w / stride == 0 || cout == 0)
    return (int)cudaGetLastError();
  Plan p;
  if (!make_plan(b, h, w, cin, hidden, cout, stride, we != nullptr, &p))
    return (int)cudaErrorInvalidValue;
  split_plan(hidden, stride, sms, &p);
  const auto aligned = [](const void* q) { return ((uintptr_t)q & 15) == 0; };
  Args a = {x, we, se, be, wd, sd, bd, wp, sp, bp, out,
            h, w, cin, hidden, cout, h / stride, w / stride, use_res,
            p.tiles_w, p.tiles_hw, p.cout_tiles, p.cs, p.per, p.kx, p.nkx,
            cin % 4 == 0 && aligned(x), hidden % 4 == 0 && (we == nullptr || aligned(we)),
            cout % 4 == 0 && aligned(wp),
            we != nullptr && p.nkx == 1 && cin % 8 == 0 && hidden % 8 == 0 && cout % 8 == 0 &&
                aligned(x) && aligned(we) && aligned(wp) && aligned(wd) && aligned(se) &&
                aligned(be) && aligned(sd) && aligned(bd),
            p.wps, p.rs,
            p.off_ring, p.stage, p.off_wp, p.off_prm, p.off_hs, p.off_ds, p.off_tab, p.off_bar};
  const long long grid = (long long)p.tiles * p.cout_tiles * p.cs;
  cudaStream_t s = (cudaStream_t)stream;
  return stride == 1 ? launch_k<1>(p.k, a, grid, p.smem, s)
                     : launch_k<2>(p.k, a, grid, p.smem, s);
}
