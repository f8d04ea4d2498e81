// Fused MobileNetV2 inverted-residual block (eval, BatchNorm folded), fp32.
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
// ho = h // stride), all NHWC and contiguous.
//
// Bound on the H100: operations. The encoder's 17 blocks at batch 8 and a
// 256x128 input do about 2.8 GFLOP against about 39 MB of compulsory
// traffic: in exact fp32 on the CUDA cores (67 TFLOP/s) about 0.042 ms,
// against 0.012 ms for the bytes. Neither hidden tensor (up to 6x the
// block's width) is ever written to device memory.
//
// Design (fp32 FMA on the CUDA cores; no tensor cores, TMA or wgmma yet):
// one CUDA block computes a TOH x TOW tile of output pixels of one image
// over a range of at most HMAX hidden channels. For each HC-channel chunk
// of that range it
//   1. expands the halo'd input patch ((TOH-1)*s+3 x (TOW-1)*s+3 pixels)
//      into the hidden chunk in shared memory, Cin in chunks of CK through
//      shared memory, and writes 0 at every patch pixel outside the image:
//      that is the depthwise conv's zero padding, which the expand's bias
//      and ReLU6 would otherwise turn into relu6(be) (the mask at
//      pallas_mbconv.py:93-103, here for rows and columns alike);
//   2. runs the depthwise 3x3 at stride s from that chunk into the block's
//      depthwise tile (P_OUT x HMAX in shared memory).
// Then it projects the depthwise tile onto Cout, TCO channels at a time.
// Small images (the last blocks have 4x8 pixels) give few tiles, so the
// hidden channels are split over blockIdx.y as well (plan(), below): with
// more than one split each block writes its partial product to a scratch
// buffer, and a second kernel sums the splits in a fixed order
// (deterministic), then applies sp, bp and the residual. Every ragged edge (image, tile, Cin,
// hidden, Cout) is masked, so every shape the reference takes is taken:
// odd H or W at stride 2 included, with no fallback.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TOH = 4, TOW = 8, P_OUT = TOH * TOW;  // output pixel tile
constexpr int HC = 32;                               // hidden channels per chunk
constexpr int HMAX = 192;                            // hidden channels per block
constexpr int CK = 32;                               // input channels per expand step
constexpr int TCO = 64;                              // output channels per project pass
constexpr int NT = 256;                              // threads per block

template <int S>
struct Tile {
  static constexpr int PH = (TOH - 1) * S + 3, PW = (TOW - 1) * S + 3;
  static constexpr int P_IN = PH * PW;               // halo'd input patch pixels
  static constexpr int KP = (P_IN + 31) / 32;        // patch pixels per expand thread
  static constexpr int SMEM_FLOATS =
      CK * HC + P_IN * (CK + 1) + P_IN * (HC + 1) + P_OUT * (HMAX + 1);
};

__device__ __forceinline__ float relu6(float v) { return fminf(fmaxf(v, 0.f), 6.f); }

template <int S>
__global__ void __launch_bounds__(NT)
mbconv_kernel(const float* __restrict__ x, const float* __restrict__ we,
              const float* __restrict__ se, const float* __restrict__ be,
              const float* __restrict__ wd, const float* __restrict__ sd,
              const float* __restrict__ bd, const float* __restrict__ wp,
              const float* __restrict__ sp, const float* __restrict__ bp,
              float* __restrict__ out, float* __restrict__ partial, int h, int w,
              int cin, int hidden, int cout, int use_res, int chunks_per_split,
              int tiles_w, long long n_out) {
  using T = Tile<S>;
  extern __shared__ __align__(16) float smem[];
  float* we_s = smem;                        // [CK][HC]
  float* x_s = we_s + CK * HC;               // [P_IN][CK+1]
  float* h_s = x_s + T::P_IN * (CK + 1);     // [P_IN][HC+1]
  float* d_s = h_s + T::P_IN * (HC + 1);     // [P_OUT][HMAX+1]

  const int ho = h / S, wo = w / S;
  const int oy0 = (blockIdx.x / tiles_w) * TOH, ox0 = (blockIdx.x % tiles_w) * TOW;
  const int iy0 = oy0 * S - 1, ix0 = ox0 * S - 1;  // patch origin in the image
  const int split = blockIdx.y, bi = blockIdx.z;
  const int hid0 = split * chunks_per_split * HC;
  const int hid1 = min(hidden, hid0 + chunks_per_split * HC);
  const float* xb = x + (long long)bi * h * w * cin;
  const int tid = threadIdx.x;

  for (int hc = hid0; hc < hid1; hc += HC) {
    if (we != nullptr) {
      // 1. expand: thread (cg, pg) owns 4 hidden channels of patch pixels
      //    pg, pg + 32, ...
      const int cg = tid % (HC / 4), pg = tid / (HC / 4);
      float acc[T::KP][4];
#pragma unroll
      for (int k = 0; k < T::KP; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[k][j] = 0.f;
      for (int c0 = 0; c0 < cin; c0 += CK) {
        for (int e = tid; e < T::P_IN * CK; e += NT) {
          const int ci = e % CK, p = e / CK, c = c0 + ci;
          const int iy = iy0 + p / T::PW, ix = ix0 + p % T::PW;
          float v = 0.f;
          if (c < cin && iy >= 0 && iy < h && ix >= 0 && ix < w)
            v = __ldg(xb + ((long long)iy * w + ix) * cin + c);
          x_s[p * (CK + 1) + ci] = v;
        }
        for (int e = tid; e < CK * HC; e += NT) {
          const int j = e % HC, c = c0 + e / HC, o = hc + j;
          we_s[e] = (c < cin && o < hidden) ? __ldg(we + (long long)c * hidden + o) : 0.f;
        }
        __syncthreads();
        const int kmax = min(CK, cin - c0);
        for (int ci = 0; ci < kmax; ++ci) {
          const float4 wv = *reinterpret_cast<const float4*>(we_s + ci * HC + cg * 4);
#pragma unroll
          for (int k = 0; k < T::KP; ++k) {
            const int p = pg + 32 * k;
            if (p < T::P_IN) {
              const float a = x_s[p * (CK + 1) + ci];
              acc[k][0] = fmaf(a, wv.x, acc[k][0]);
              acc[k][1] = fmaf(a, wv.y, acc[k][1]);
              acc[k][2] = fmaf(a, wv.z, acc[k][2]);
              acc[k][3] = fmaf(a, wv.w, acc[k][3]);
            }
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int k = 0; k < T::KP; ++k) {
        const int p = pg + 32 * k;
        if (p >= T::P_IN) continue;
        const int iy = iy0 + p / T::PW, ix = ix0 + p % T::PW;
        const bool inside = iy >= 0 && iy < h && ix >= 0 && ix < w;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int o = hc + cg * 4 + j;
          h_s[p * (HC + 1) + cg * 4 + j] =
              (inside && o < hidden) ? relu6(acc[k][j] * __ldg(se + o) + __ldg(be + o)) : 0.f;
        }
      }
    } else {
      // no expand (expand_ratio 1): the hidden chunk is x itself, zero-padded
      for (int e = tid; e < T::P_IN * HC; e += NT) {
        const int j = e % HC, p = e / HC, c = hc + j;
        const int iy = iy0 + p / T::PW, ix = ix0 + p % T::PW;
        float v = 0.f;
        if (c < hidden && iy >= 0 && iy < h && ix >= 0 && ix < w)
          v = __ldg(xb + ((long long)iy * w + ix) * cin + c);
        h_s[p * (HC + 1) + j] = v;
      }
    }
    __syncthreads();

    // 2. depthwise 3x3 at stride S: thread owns one hidden channel of
    //    output pixels tid/HC, tid/HC + NT/HC, ...
    {
      const int j = tid % HC, o = hc + j;
      const bool live = o < hidden;
      float wk[9];
#pragma unroll
      for (int t = 0; t < 9; ++t) wk[t] = live ? __ldg(wd + (long long)t * hidden + o) : 0.f;
      const float s_d = live ? __ldg(sd + o) : 0.f, b_d = live ? __ldg(bd + o) : 0.f;
      for (int pp = tid / HC; pp < P_OUT; pp += NT / HC) {
        const int ty = pp / TOW, tx = pp % TOW;
        float acc = 0.f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            acc = fmaf(h_s[((ty * S + dy) * T::PW + tx * S + dx) * (HC + 1) + j],
                       wk[dy * 3 + dx], acc);
        d_s[pp * (HMAX + 1) + (hc - hid0) + j] = live ? relu6(acc * s_d + b_d) : 0.f;
      }
    }
    __syncthreads();
  }

  // 3. project: thread (cg, pg) owns 4 output channels of pixels 2pg, 2pg+1
  const int kn = hid1 - hid0;
  const int cg = tid % (TCO / 4), p0 = (tid / (TCO / 4)) * 2;
  for (int co0 = 0; co0 < cout; co0 += TCO) {
    const int o = co0 + cg * 4;
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int k = 0; k < kn; ++k) {
      const float* wrow = wp + (long long)(hid0 + k) * cout + o;
      float wv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = (o + j < cout) ? __ldg(wrow + j) : 0.f;
      const float a0 = d_s[p0 * (HMAX + 1) + k], a1 = d_s[(p0 + 1) * (HMAX + 1) + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[0][j] = fmaf(a0, wv[j], acc[0][j]);
        acc[1][j] = fmaf(a1, wv[j], acc[1][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int oy = oy0 + (p0 + i) / TOW, ox = ox0 + (p0 + i) % TOW;
      if (oy >= ho || ox >= wo) continue;
      const long long base = (((long long)bi * ho + oy) * wo + ox) * cout;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (o + j >= cout) break;
        const long long idx = base + o + j;
        if (partial != nullptr) {
          partial[(long long)split * n_out + idx] = acc[i][j];
        } else {
          float v = acc[i][j] * __ldg(sp + o + j) + __ldg(bp + o + j);
          if (use_res) v += __ldg(x + idx);
          out[idx] = v;
        }
      }
    }
  }
}

// out = (sum of the splits' partial products, in split order) * sp + bp (+ x)
__global__ void __launch_bounds__(NT)
mbconv_reduce_kernel(const float* __restrict__ partial, const float* __restrict__ x,
                     const float* __restrict__ sp, const float* __restrict__ bp,
                     float* __restrict__ out, long long n_out, int cout, int splits,
                     int use_res) {
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < n_out;
       i += (long long)gridDim.x * NT) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += __ldg(partial + (long long)k * n_out + i);
    const int c = (int)(i % cout);
    float v = s * __ldg(sp + c) + __ldg(bp + c);
    if (use_res) v += __ldg(x + i);
    out[i] = v;
  }
}

template <int S>
int launch(const float* x, const float* we, const float* se, const float* be,
           const float* wd, const float* sd, const float* bd, const float* wp,
           const float* sp, const float* bp, float* out, float* partial, int b, int h,
           int w, int cin, int hidden, int cout, int use_res, int splits,
           int chunks_per_split, cudaStream_t stream) {
  const int ho = h / S, wo = w / S;
  const int tiles_w = (wo + TOW - 1) / TOW, tiles_h = (ho + TOH - 1) / TOH;
  const long long n_out = (long long)b * ho * wo * cout;
  const size_t smem = sizeof(float) * Tile<S>::SMEM_FLOATS;
  cudaError_t err = cudaFuncSetAttribute(
      mbconv_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(tiles_h * tiles_w, splits, b);
  mbconv_kernel<S><<<grid, NT, smem, stream>>>(
      x, we, se, be, wd, sd, bd, wp, sp, bp, out, splits > 1 ? partial : nullptr, h, w, cin,
      hidden, cout, use_res, chunks_per_split, tiles_w, n_out);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long blocks = (n_out + NT - 1) / NT;
  mbconv_reduce_kernel<<<(int)(blocks < 65536 ? blocks : 65536), NT, 0, stream>>>(
      partial, x, sp, bp, out, n_out, cout, splits, use_res);
  return (int)cudaGetLastError();
}

// How many CUDA blocks share the hidden channels of one output tile
// (`splits`), and how many HC-channel chunks each takes (`per`): enough
// splits that no block holds more than HMAX channels, and up to one chunk
// each while the grid stays within two waves of the card's `sms` SMs.
void plan(int b, int ho, int wo, int hidden, int sms, int* splits, int* per) {
  const long long tiles = (long long)b * ((ho + TOH - 1) / TOH) * ((wo + TOW - 1) / TOW);
  const long long nchunks = hidden > HC ? (hidden + HC - 1) / HC : 1;
  const long long want = (2LL * sms + tiles - 1) / (tiles > 0 ? tiles : 1);
  const long long least = (nchunks + HMAX / HC - 1) / (HMAX / HC);
  const long long s = want > least ? (want < nchunks ? want : nchunks) : least;
  *per = (int)((nchunks + s - 1) / s);
  *splits = (int)((nchunks + *per - 1) / *per);
}

}  // namespace

// The split of the hidden channels that tpuseg_mbconv makes for these sizes
// on a card with `sms` SMs. With *splits > 1 the launch needs `partial`:
// *splits x B*(H/s)*(W/s)*Cout floats of scratch. Returns a cudaError_t.
extern "C" int tpuseg_mbconv_plan(int b, int h, int w, int hidden, int stride, int sms,
                                  int* splits, int* per) {
  if ((stride != 1 && stride != 2) || sms < 1 || hidden < 1) return (int)cudaErrorInvalidValue;
  plan(b, h / stride, w / stride, hidden, sms, splits, per);
  return 0;
}

// Launches on `stream`; returns a cudaError_t (0 on success). `we`, `se` and
// `be` are null for a block without expand. `partial` is the scratch that
// tpuseg_mbconv_plan asks for, given the same `sms` (null when it asks for
// none).
extern "C" int tpuseg_mbconv(const float* x, const float* we, const float* se,
                             const float* be, const float* wd, const float* sd,
                             const float* bd, const float* wp, const float* sp,
                             const float* bp, float* out, float* partial, int b, int h,
                             int w, int cin, int hidden, int cout, int stride, int use_res,
                             int sms, void* stream) {
  int splits = 1, per = 1;
  const int rc = tpuseg_mbconv_plan(b, h, w, hidden, stride, sms, &splits, &per);
  if (rc != 0 || (splits > 1 && !partial) || (we == nullptr && cin != hidden) ||
      (use_res && (stride != 1 || cin != cout)))
    return rc != 0 ? rc : (int)cudaErrorInvalidValue;
  if (b == 0 || h / stride == 0 || w / stride == 0 || cout == 0)
    return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  return stride == 1
             ? launch<1>(x, we, se, be, wd, sd, bd, wp, sp, bp, out, partial, b, h, w, cin,
                         hidden, cout, use_res, splits, per, s)
             : launch<2>(x, we, se, be, wd, sd, bd, wp, sp, bp, out, partial, b, h, w, cin,
                         hidden, cout, use_res, splits, per, s);
}
