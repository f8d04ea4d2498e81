// Fused bilinear-x2 upsample + skip concat + 3x3 conv (+bias), exact to fp32,
// as an implicit GEMM on the tensor cores.
//
// Replaces the TPU kernel tpuseg/ops/pallas_kernels.py:314
// fused_upsample_concat_conv (body _upconcat_kernel, :253):
//
//   out = conv3x3(cat([skip, up2x_half_pixel(x)], C), w, pad=1) + b
//
// skip f32 [B,2H,2W,Cs], x f32 [B,H,W,Cx], w f32 HWIO [3,3,Cs+Cx,Cout],
// b f32 [Cout] -> out f32 [B,2H,2W,Cout], all NHWC and contiguous. Neither
// the upsampled tensor nor the concat is ever written to device memory.
// BatchNorm and the activation stay in the caller.
//
// The GEMM: M = B*2H*2W output pixels, N = Cout, K = 9*(Cs+Cx). A is built
// on the fly from a halo'd input patch in shared memory; B is the HWIO
// weight slice [K-chunk, N-tile].
//
// Bound on the H100: operations. The decoder's four calls at batch 8 and a
// 256x128 input do 14.95 GFLOP of fp32 multiply-adds (up1 alone 6.3),
// against about 20 MB of compulsory traffic. Exact fp32 on the CUDA cores
// (67 TFLOP/s) would take at least 0.223 ms. This kernel takes the
// tensor-core route, 3 TF32 products per fp32 term at 495 TFLOP/s: at least
// 3 x 14.95 GFLOP / 495 TFLOP/s = 0.091 ms.
//
// Why 3xTF32. One TF32 product keeps 10 mantissa bits: at up1's K = 12,096
// that is an error of about 3e-3 on outputs of about 5, far outside the
// 1e-4 the kernel is held to. Each fp32 operand is split into
// big = tf32(a) (round to nearest) and small = a - big (exact; the tensor
// core reads its top 19 bits), and small*big + big*small + big*big are
// accumulated in fp32 (mma.sync.m16n8k8 tf32): the dropped small*small
// term and the truncation of small leave about 2^-21 of each product. The
// tensor core's own fp32 sums truncate toward zero, so only one tap's 16
// terms (6 products) are chained on it, from zero; each tap's sum is then
// added to the running sum in round-to-nearest fp32 on the CUDA cores.
// Against a float64 reference this comes out closer than the plain
// version (cuDNN's fp32 sum over K in order); chip_smoke.py holds it to at
// most twice the plain version's error.
//
// Design. One block (8 warps, 4 along M x 2 along N) computes an 8 x 16
// pixel tile (BM = 128) of one image for BN = 64 (or 32, when Cout <= 32)
// output channels; each warp a 32 x BN/2 tile of m16n8 products. It walks
// its share of the Cs+Cx input channels in chunks of CK = 16 (K = 144 per
// chunk), double-buffered in dynamic shared memory (107 KB at BN = 64, two
// blocks per SM). Per chunk:
//   - cp.async stages the skip channels of the 10 x 18 halo'd patch (zero
//     filled outside the image: the conv's zero padding, the mask at
//     pallas_kernels.py:286), the weight slice [9 x CK, BN] (XOR-swizzled
//     by K row so that the B fragments are read without bank conflicts),
//     and the 6 x 10 x-source patch that the x channels are rebuilt from;
//   - the x channels of the patch are rebuilt from the x-source patch with
//     the half-pixel 0.25/0.75 taps, edge-clamped, H lerp then W lerp, each
//     product rounded as the JAX package's are (half_pixel_taps, lerp_rn):
//     bit-equal to the upsample the plain version materializes;
//   - the warps run 18 k-steps of 8 (9 taps x 2) of 3xTF32 mma.sync,
//     adding each tap's sum to the running sum.
// Chunk k+1's weights and skip channels are in flight during chunk k's
// rebuild and products, its x-source patch during chunk k's products.
//
// Split K. up1's M x N is only 1024 x 256: 32 tiles on 132 SMs. Where the
// tiles do not fill the card's resident slots (two blocks per SM, the SM
// count read from the device), the chunks are split over blockIdx.z, up to
// one full wave of resident blocks (tpuseg_upconcat_plan). Each split writes
// its partial tile to scratch that the wrapper allocates, and a second
// kernel sums the splits in split order and adds the bias: deterministic,
// no float atomics. Shapes with enough tiles (up4: M = 65,536) take no
// split and add the bias in the epilogue.
//
// Every ragged M, N, Cs, Cx and K-chunk edge is masked (and 16-byte copies
// are taken only where the channel counts and pointers allow them), so
// every shape the model produces is taken, with no fallback.
//
// Left for later: wgmma (for tf32 it wants both operands K-major in shared
// memory; the weights are N-major HWIO and A's x half is computed, not
// loaded), TMA for the weight tiles, splitting the operands once per chunk
// in shared memory instead of at every fragment load, and a persistent grid.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int TH = 8, TW = 16;                     // output pixel tile (BM = 128)
constexpr int PH = TH + 2, PW = TW + 2;            // halo'd input patch
constexpr int SH = TH / 2 + 2, SW = TW / 2 + 2;    // x-source patch it is rebuilt from
constexpr int CK = 16;                             // input channels per K-chunk
constexpr int CKP = 20;                            // patch channel stride: conflict-free A loads
constexpr int NT = 256;                            // 8 warps: 4 along M x 2 along N
constexpr int RESIDENT = 2;                        // blocks per SM (launch bounds, shared memory)
constexpr int PATCH_FLOATS = PH * PW * CKP;
constexpr int XSRC_FLOATS = SH * SW * CKP;

template <int BN>
struct Smem {
  static constexpr int STAGE = PATCH_FLOATS + 9 * CK * BN;   // patch, then weights
  static constexpr int BYTES = 4 * (2 * STAGE + XSRC_FLOATS);
};

// Half-pixel (align_corners=False) x2 taps for output index g of n inputs:
// src = (g + 0.5) / 2 - 0.5 clamped to [0, n-1]; all values exact in f32.
__device__ __forceinline__ void half_pixel_taps(int g, int n, int* lo, int* hi,
                                                float* w_lo, float* w_hi) {
  float src = fminf(fmaxf((g + 0.5f) * 0.5f - 0.5f, 0.f), (float)(n - 1));
  int l = (int)src;
  float f = src - (float)l;
  *lo = l;
  *hi = min(l + 1, n - 1);
  *w_lo = 1.f - f;
  *w_hi = f;
}

__device__ __forceinline__ float lerp_rn(float a, float wa, float b, float wb) {
  return __fadd_rn(__fmul_rn(a, wa), __fmul_rn(b, wb));
}

template <int BN>
__global__ void __launch_bounds__(NT, RESIDENT)
upconcat_mma_kernel(const float* __restrict__ skip, const float* __restrict__ x,
                    const float* __restrict__ wgt, const float* __restrict__ bias,
                    float* __restrict__ out, float* __restrict__ partial, int h2, int w2,
                    int cs, int cx, int cout, int tiles_w, int tiles_hw, int chunks_per_split,
                    int vec_a, int vec_w, long long n_out) {
  constexpr int WN = BN / 16;                      // n8 tiles per warp
  constexpr int STAGE = Smem<BN>::STAGE;
  extern __shared__ __align__(16) float smem[];
  float* xsrc = smem + 2 * STAGE;

  const int h = h2 >> 1, w = w2 >> 1, cin = cs + cx;
  const int img = blockIdx.x / tiles_hw, tile = blockIdx.x % tiles_hw;
  const int ty0 = (tile / tiles_w) * TH, tx0 = (tile % tiles_w) * TW;
  const int sy0 = ty0 / 2 - 1, sx0 = tx0 / 2 - 1;  // x-source patch origin
  const int n0 = blockIdx.y * BN;
  const int k_begin = blockIdx.z * chunks_per_split;
  const int k_end = min((cin + CK - 1) / CK, k_begin + chunks_per_split);
  const float* skip_b = skip + (long long)img * h2 * w2 * cs;
  const float* x_b = x + (long long)img * h * w * cx;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;         // rows 2wm, 2wm+1; columns wn*BN/2..

  // skip channels of the halo'd patch and the weight slice of chunk kc
  auto stage_main = [&](int kc, int buf) {
    const int c0 = kc * CK;
    float* patch = smem + buf * STAGE;
    float* ws = patch + PATCH_FLOATS;
    if (c0 < cs) {
      const int vw = vec_a ? 4 : 1;
      for (int e = tid; e < PH * PW * (CK / vw); e += NT) {
        const int ci = (e % (CK / vw)) * vw, pp = e / (CK / vw), c = c0 + ci;
        if (c >= cs) continue;
        const int gy = ty0 - 1 + pp / PW, gx = tx0 - 1 + pp % PW;
        const bool in = gy >= 0 && gy < h2 && gx >= 0 && gx < w2;
        const float* src = in ? skip_b + ((long long)gy * w2 + gx) * cs + c : skip;
        if (vec_a)
          cp_async16(patch + pp * CKP + ci, src, in);
        else
          cp_async4(patch + pp * CKP + ci, src, in);
      }
    }
    const int vw = vec_w ? 4 : 1;
    for (int e = tid; e < 9 * CK * (BN / vw); e += NT) {
      const int col = (e % (BN / vw)) * vw, kk = e / (BN / vw);   // kk = tap * CK + ci
      const int c = c0 + kk % CK, n = n0 + col;
      const bool ok = c < cin && n < cout;
      const float* src = ok ? wgt + ((long long)(kk / CK) * cin + c) * cout + n : wgt;
      float* dst = ws + kk * BN + (col ^ ((kk & 3) << 3));
      if (vec_w)
        cp_async16(dst, src, ok);
      else
        cp_async4(dst, src, ok);
    }
  };

  // the x-source patch (rows sy0.., columns sx0..) of chunk kc's x channels
  auto stage_x = [&](int kc) {
    const int c0 = kc * CK;
    if (c0 + CK <= cs) return;
    const int vw = vec_a ? 4 : 1;
    for (int e = tid; e < SH * SW * (CK / vw); e += NT) {
      const int ci = (e % (CK / vw)) * vw, sp = e / (CK / vw), c = c0 + ci;
      const int hy = sy0 + sp / SW, hx = sx0 + sp % SW;
      if (c < cs || c >= cin || hy < 0 || hy >= h || hx < 0 || hx >= w) continue;
      const float* src = x_b + ((long long)hy * w + hx) * cx + (c - cs);
      if (vec_a)
        cp_async16(xsrc + sp * CKP + ci, src, true);
      else
        cp_async4(xsrc + sp * CKP + ci, src, true);
    }
  };

  // rebuild chunk kc's upsampled x channels (0 past Cin and outside the image)
  auto build = [&](int kc, int buf) {
    const int c0 = kc * CK;
    if (c0 + CK <= cs) return;
    float* patch = smem + buf * STAGE;
    for (int e = tid; e < PH * PW * CK; e += NT) {
      const int ci = e % CK, pp = e / CK, c = c0 + ci;
      if (c < cs) continue;
      const int gy = ty0 - 1 + pp / PW, gx = tx0 - 1 + pp % PW;
      float v = 0.f;
      if (c < cin && gy >= 0 && gy < h2 && gx >= 0 && gx < w2) {
        int h0, h1, w0, w1;
        float wh0, wh1, ww0, ww1;
        half_pixel_taps(gy, h, &h0, &h1, &wh0, &wh1);
        half_pixel_taps(gx, w, &w0, &w1, &ww0, &ww1);
        const float* r0 = xsrc + (h0 - sy0) * SW * CKP + ci;
        const float* r1 = xsrc + (h1 - sy0) * SW * CKP + ci;
        const int o0 = (w0 - sx0) * CKP, o1 = (w1 - sx0) * CKP;
        v = lerp_rn(lerp_rn(r0[o0], wh0, r1[o0], wh1), ww0, lerp_rn(r0[o1], wh0, r1[o1], wh1),
                    ww1);
      }
      patch[pp * CKP + ci] = v;
    }
  };

  float acc[2][WN][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  if (k_begin < k_end) {
    stage_main(k_begin, 0);
    cp_async_commit();
    stage_x(k_begin);
    cp_async_commit();
  }
  for (int kc = k_begin; kc < k_end; ++kc) {
    const int buf = (kc - k_begin) & 1;
    cp_async_wait_all();
    __syncthreads();                 // chunk kc has landed; chunk kc-1's products are done
    if (kc + 1 < k_end) stage_main(kc + 1, buf ^ 1);
    cp_async_commit();
    build(kc, buf);
    __syncthreads();                 // the patch is whole; the x-source patch is free
    if (kc + 1 < k_end) stage_x(kc + 1);
    cp_async_commit();

    const float* patch = smem + buf * STAGE;
    const float* ws = patch + PATCH_FLOATS;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      // the tap's 16 terms (2 k-steps, 6 products) start from zero on the
      // tensor core; then one round-to-nearest add into the running sum
      float d[2][WN][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < WN; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) d[i][j][q] = 0.f;
#pragma unroll
      for (int ks = 0; ks < CK / 8; ++ks) {
        uint32_t ab[2][4], as[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          // rows g and g+8 of the m16 tile are pixels g and g+8 of tile row 2wm+i
          const float* pa = patch + ((2 * wm + i + dy) * PW + dx + g) * CKP + ks * 8 + t;
          split_tf32(pa[0], ab[i][0], as[i][0]);
          split_tf32(pa[8 * CKP], ab[i][1], as[i][1]);
          split_tf32(pa[4], ab[i][2], as[i][2]);
          split_tf32(pa[8 * CKP + 4], ab[i][3], as[i][3]);
        }
        const int kk = tap * CK + ks * 8 + t;      // kk & 3 == t: the row's swizzle
        const float* pb0 = ws + kk * BN;
        const float* pb1 = pb0 + 4 * BN;
#pragma unroll
        for (int j = 0; j < WN; ++j) {
          const int col = (wn * (BN / 2) + 8 * j + g) ^ (t << 3);
          uint32_t bb0, bs0, bb1, bs1;
          split_tf32(pb0[col], bb0, bs0);
          split_tf32(pb1[col], bb1, bs1);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma_tf32(d[i][j], as[i], bb0, bb1);
            mma_tf32(d[i][j], ab[i], bs0, bs1);
            mma_tf32(d[i][j], ab[i], bb0, bb1);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < WN; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j][q] += d[i][j][q];
    }
  }

  // epilogue: d0,d1 are (pixel g, channels 2t, 2t+1), d2,d3 pixel g+8
  float* dst = partial != nullptr ? partial + (long long)blockIdx.z * n_out : out;
  const bool pairs = (cout & 1) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gy = ty0 + 2 * wm + i;
    if (gy >= h2) continue;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int gx = tx0 + g + 8 * hf;
      if (gx >= w2) continue;
      float* row = dst + (((long long)img * h2 + gy) * w2 + gx) * cout;
#pragma unroll
      for (int j = 0; j < WN; ++j) {
        const int n = n0 + wn * (BN / 2) + 8 * j + 2 * t;
        float v0 = acc[i][j][2 * hf], v1 = acc[i][j][2 * hf + 1];
        if (partial == nullptr) {
          if (n < cout) v0 += __ldg(bias + n);
          if (n + 1 < cout) v1 += __ldg(bias + n + 1);
        }
        if (pairs && n + 1 < cout) {
          *reinterpret_cast<float2*>(row + n) = make_float2(v0, v1);
        } else {
          if (n < cout) row[n] = v0;
          if (n + 1 < cout) row[n + 1] = v1;
        }
      }
    }
  }
}

// out = (the splits' partial tiles summed in split order) + bias
__global__ void __launch_bounds__(NT)
upconcat_reduce_kernel(const float* __restrict__ partial, const float* __restrict__ bias,
                       float* __restrict__ out, long long n_out, int cout, int splits) {
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < n_out;
       i += (long long)gridDim.x * NT) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += __ldg(partial + (long long)k * n_out + i);
    out[i] = s + __ldg(bias + (int)(i % cout));
  }
}

int tile_n(int cout) { return cout > 32 ? 64 : 32; }

// How many CUDA blocks share the K-chunks of one output tile (`splits`),
// and how many chunks each takes (`per`): while the output tiles fill
// fewer than RESIDENT blocks on each of the `sms` SMs, as many splits as
// keep the grid within that one wave of resident blocks (at most one
// split per chunk).
void plan(int b, int h2, int w2, int cin, int cout, int sms, int* splits, int* per) {
  const long long tiles = (long long)b * ((h2 + TH - 1) / TH) * ((w2 + TW - 1) / TW) *
                          ((cout + tile_n(cout) - 1) / tile_n(cout));
  const long long nchunks = cin > CK ? (cin + CK - 1) / CK : 1;
  long long s = tiles > 0 ? (long long)RESIDENT * sms / tiles : 1;
  s = s < 1 ? 1 : (s > nchunks ? nchunks : s);
  *per = (int)((nchunks + s - 1) / s);
  *splits = (int)((nchunks + *per - 1) / *per);
}

template <int BN>
int launch(const float* skip, const float* x, const float* w, const float* bias, float* out,
           float* partial, int b, int h2, int w2, int cs, int cx, int cout, int splits,
           int per, cudaStream_t stream) {
  const int tiles_w = (w2 + TW - 1) / TW, tiles_hw = ((h2 + TH - 1) / TH) * tiles_w;
  const long long n_out = (long long)b * h2 * w2 * cout;
  const auto aligned = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  const int vec_a = cs % 4 == 0 && cx % 4 == 0 && aligned(skip) && aligned(x);
  const int vec_w = cout % 4 == 0 && aligned(w);
  const int smem = Smem<BN>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(upconcat_mma_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(b * tiles_hw, (cout + BN - 1) / BN, splits);
  upconcat_mma_kernel<BN><<<grid, NT, smem, stream>>>(
      skip, x, w, bias, out, splits > 1 ? partial : nullptr, h2, w2, cs, cx, cout, tiles_w,
      tiles_hw, per, vec_a, vec_w, n_out);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long blocks = (n_out + NT - 1) / NT;
  upconcat_reduce_kernel<<<(int)(blocks < 65536 ? blocks : 65536), NT, 0, stream>>>(
      partial, bias, out, n_out, cout, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// The K split that tpuseg_upconcat_conv makes for these sizes on a card
// with `sms` SMs. With *splits > 1 the launch needs `partial`: *splits x
// B*2H*2W*Cout floats of scratch. Returns a cudaError_t.
extern "C" int tpuseg_upconcat_plan(int b, int h2, int w2, int cs, int cx, int cout, int sms,
                                    int* splits, int* per) {
  if (sms < 1 || b < 0 || h2 < 0 || w2 < 0 || cs < 0 || cx < 0 || cout < 0)
    return (int)cudaErrorInvalidValue;
  plan(b, h2, w2, cs + cx, cout, sms, splits, per);
  return 0;
}

// Launches on `stream`; returns a cudaError_t (0 on success). `partial` is
// the scratch that tpuseg_upconcat_plan asks for, given the same `sms`
// (null when it asks for none).
extern "C" int tpuseg_upconcat_conv(const float* skip, const float* x, const float* w,
                                    const float* bias, float* out, float* partial, int b,
                                    int h2, int w2, int cs, int cx, int cout, int sms,
                                    void* stream) {
  int splits = 1, per = 1;
  const int rc = tpuseg_upconcat_plan(b, h2, w2, cs, cx, cout, sms, &splits, &per);
  if (rc != 0 || (h2 & 1) || (w2 & 1) || (splits > 1 && !partial))
    return rc != 0 ? rc : (int)cudaErrorInvalidValue;
  if (b == 0 || h2 == 0 || w2 == 0 || cout == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  return tile_n(cout) == 64
             ? launch<64>(skip, x, w, bias, out, partial, b, h2, w2, cs, cx, cout, splits, per, s)
             : launch<32>(skip, x, w, bias, out, partial, b, h2, w2, cs, cx, cout, splits, per, s);
}
