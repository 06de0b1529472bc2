// Two fused 3x3x3 stride-1 convolutions for Hopper (sm_90a).
//
// Replaces: ecm_tpu/ops/pallas_fused_agg.py, _make_kernel (the pallas_call
// in _fused_conv3d_pair_pallas), reached through fused_conv3d_pair.
//
// Computes, for x [B, D, H, W, Cin] (NDHWC, bf16 or f32):
//   y   = E1(conv(x, k1))             rounded to the input type
//   out = E2(conv(y, k2)) [+ ctx] [+ x[..., :Cout]]
// with Ei(v) = relu?(v * scale_i + bias_i) in f32, both convs zero-padded by
// one voxel, ctx [B, H, W, Cout] broadcast over D. The intermediate y never
// leaves the SM. Accumulation is f32.
//
// Bound on the H100: arithmetic. At the main-path shape (1,437,696 voxels)
// dres0 (64->32->32) is 238.5 GFLOP, dres1 (32->32->32) 159.0 GFLOP and the
// classifier (32->32->1) 82.0 GFLOP, against 276 MB or less of traffic:
// compute-bound at any rate the card offers.
//
// Design (simple and right first; tensor cores, TMA and wgmma come later):
// one block per output tile of TD x TH x TW voxels. Stage 1 computes y over
// the tile plus a one-voxel halo into shared memory, channel-major
// ([Cm][positions], so a warp's 32 neighbouring positions hit distinct
// banks), with every position outside the volume set to ZERO: stage 2
// zero-pads y, so those positions must not hold the convolution evaluated on
// padding. Each stage-1 thread owns one position and 32 output channels in
// registers and reads x with 16-byte vector loads through the read-only
// cache. Stage 2 runs from shared memory, one thread per output voxel and
// group of CO2 output channels (CO2 = 32, or 1 for the classifier), and
// applies the epilogue. Weights come in as f32 (already rounded to the input
// type), padded to the channel group, and are read through the read-only
// cache: every thread of a warp reads the same address, a broadcast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCm = 32;  // stage-1 output channels held in registers per pass

struct Params {
  const void* x;
  const float* k1;  // [27][Cin][Cm_pad]
  const float* s1;
  const float* b1;
  const float* k2;  // [27][Cm][Cout_pad]
  const float* s2;
  const float* b2;
  const void* ctx;  // [B, H, W, Cout] or null
  void* out;        // [B, D, H, W, Cout]
  int B, D, H, W, Cin, Cm, Cm_pad, Cout, Cout_pad;
  int relu1, relu2, residual;
  int td, th, tw, nd, nh, nw;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 16-byte vector load of N consecutive input values, widened to f32.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* o) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* o) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      o[2 * k] = f.x;
      o[2 * k + 1] = f.y;
    }
  }
};

// acc[0:32] += xv * w[0:32] with w 16-byte aligned.
__device__ __forceinline__ void fma32(float* acc, float xv, const float* w) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float4 q = __ldg(w4 + k);
    acc[4 * k] += xv * q.x;
    acc[4 * k + 1] += xv * q.y;
    acc[4 * k + 2] += xv * q.z;
    acc[4 * k + 3] += xv * q.w;
  }
}

template <typename T, int CO2>
__global__ void __launch_bounds__(kThreads, 2) fused_pair_kernel(const Params P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* y1 = reinterpret_cast<T*>(smem_raw);  // [Cm][P1]
  const T* x = static_cast<const T*>(P.x);

  int blk = blockIdx.x;
  const int tw_i = blk % P.nw; blk /= P.nw;
  const int th_i = blk % P.nh; blk /= P.nh;
  const int td_i = blk % P.nd;
  const int b = blk / P.nd;
  const int d0 = td_i * P.td, h0 = th_i * P.th, w0 = tw_i * P.tw;
  const int ed = P.td + 2, eh = P.th + 2, ew = P.tw + 2;
  const int P1 = ed * eh * ew;
  const bool vec_ok = P.Cin % Vec<T>::N == 0;

  // ---- stage 1: y over the tile and its halo, zero outside the volume ----
  for (int p = threadIdx.x; p < P1; p += kThreads) {
    const int lw = p % ew, lh = (p / ew) % eh, ld = p / (ew * eh);
    const int ad = d0 - 1 + ld, ah = h0 - 1 + lh, aw = w0 - 1 + lw;
    const bool inside = ad >= 0 && ad < P.D && ah >= 0 && ah < P.H && aw >= 0 && aw < P.W;
    for (int c0 = 0; c0 < P.Cm; c0 += kCm) {
      float acc[kCm];
#pragma unroll
      for (int j = 0; j < kCm; ++j) acc[j] = 0.f;
      if (inside) {
        for (int kd = 0; kd < 3; ++kd) {
          const int id = ad + kd - 1;
          if (id < 0 || id >= P.D) continue;
          for (int kh = 0; kh < 3; ++kh) {
            const int ih = ah + kh - 1;
            if (ih < 0 || ih >= P.H) continue;
            for (int kw = 0; kw < 3; ++kw) {
              const int iw = aw + kw - 1;
              if (iw < 0 || iw >= P.W) continue;
              const T* xp = x + ((((size_t)b * P.D + id) * P.H + ih) * P.W + iw) * P.Cin;
              const float* wp = P.k1 + (size_t)((kd * 3 + kh) * 3 + kw) * P.Cin * P.Cm_pad + c0;
              if (vec_ok) {
                for (int ci = 0; ci < P.Cin; ci += Vec<T>::N) {
                  float xv[Vec<T>::N];
                  Vec<T>::load(xp + ci, xv);
#pragma unroll
                  for (int j = 0; j < Vec<T>::N; ++j)
                    fma32(acc, xv[j], wp + (size_t)(ci + j) * P.Cm_pad);
                }
              } else {
                for (int ci = 0; ci < P.Cin; ++ci)
                  fma32(acc, to_f32(xp[ci]), wp + (size_t)ci * P.Cm_pad);
              }
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kCm; ++j) {
        const int c = c0 + j;
        if (c < P.Cm) {
          float v = 0.f;
          if (inside) {
            v = acc[j] * __ldg(P.s1 + c) + __ldg(P.b1 + c);
            if (P.relu1) v = fmaxf(v, 0.f);
          }
          y1[(size_t)c * P1 + p] = from_f32<T>(v);
        }
      }
    }
  }
  __syncthreads();

  // ---- stage 2: out over the tile from shared memory, then the epilogue ----
  const int P2 = P.td * P.th * P.tw;
  const int groups = P.Cout_pad / CO2;
  const T* ctx = static_cast<const T*>(P.ctx);
  T* out = static_cast<T*>(P.out);
  for (int task = threadIdx.x; task < P2 * groups; task += kThreads) {
    const int q = task % P2, g = task / P2;
    const int lw = q % P.tw, lh = (q / P.tw) % P.th, ld = q / (P.tw * P.th);
    const int ad = d0 + ld, ah = h0 + lh, aw = w0 + lw;
    if (ad >= P.D || ah >= P.H || aw >= P.W) continue;
    float acc[CO2];
#pragma unroll
    for (int j = 0; j < CO2; ++j) acc[j] = 0.f;
    for (int kd = 0; kd < 3; ++kd)
      for (int kh = 0; kh < 3; ++kh)
        for (int kw = 0; kw < 3; ++kw) {
          const int pos = ((ld + kd) * eh + (lh + kh)) * ew + (lw + kw);
          const float* wp =
              P.k2 + (size_t)((kd * 3 + kh) * 3 + kw) * P.Cm * P.Cout_pad + g * CO2;
          for (int cm = 0; cm < P.Cm; ++cm) {
            const float yv = to_f32(y1[(size_t)cm * P1 + pos]);
            if constexpr (CO2 == 32) {
              fma32(acc, yv, wp + (size_t)cm * P.Cout_pad);
            } else {
#pragma unroll
              for (int j = 0; j < CO2; ++j)
                acc[j] += yv * __ldg(wp + (size_t)cm * P.Cout_pad + j);
            }
          }
        }
    const size_t vox = (((size_t)b * P.D + ad) * P.H + ah) * P.W + aw;
#pragma unroll
    for (int j = 0; j < CO2; ++j) {
      const int co = g * CO2 + j;
      if (co < P.Cout) {
        float v = acc[j] * __ldg(P.s2 + co) + __ldg(P.b2 + co);
        if (P.relu2) v = fmaxf(v, 0.f);
        if (ctx) v += to_f32(ctx[(((size_t)b * P.H + ah) * P.W + aw) * P.Cout + co]);
        if (P.residual) v += to_f32(x[vox * P.Cin + co]);
        out[vox * P.Cout + co] = from_f32<T>(v);
      }
    }
  }
}

template <typename T, int CO2>
cudaError_t launch(const Params& P, cudaStream_t stream) {
  const size_t smem =
      (size_t)P.Cm * (P.td + 2) * (P.th + 2) * (P.tw + 2) * sizeof(T);
  auto kernel = fused_pair_kernel<T, CO2>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)P.B * P.nd * P.nh * P.nw;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(P);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, ctx and out). k1 is f32
// [27][Cin][Cm_pad] with Cm_pad = Cm rounded up to 32; k2 is f32
// [27][Cm][Cout_pad] with Cout_pad = 1 if Cout == 1 else Cout rounded up to
// 32; pads are zero. scale/bias are f32. ctx may be null. All pointers are
// 16-byte aligned. (td, th, tw) is the output tile.
extern "C" int ecm_fused_conv3d_pair(
    int dtype, const void* x, const void* k1, const void* s1, const void* b1,
    const void* k2, const void* s2, const void* b2, const void* ctx, void* out,
    int B, int D, int H, int W, int Cin, int Cm, int Cout, int relu1, int relu2,
    int residual, int td, int th, int tw, void* stream) {
  Params P;
  P.x = x;
  P.k1 = static_cast<const float*>(k1);
  P.s1 = static_cast<const float*>(s1);
  P.b1 = static_cast<const float*>(b1);
  P.k2 = static_cast<const float*>(k2);
  P.s2 = static_cast<const float*>(s2);
  P.b2 = static_cast<const float*>(b2);
  P.ctx = ctx;
  P.out = out;
  P.B = B; P.D = D; P.H = H; P.W = W;
  P.Cin = Cin; P.Cm = Cm; P.Cout = Cout;
  P.Cm_pad = (Cm + kCm - 1) / kCm * kCm;
  P.Cout_pad = Cout == 1 ? 1 : (Cout + 31) / 32 * 32;
  P.relu1 = relu1; P.relu2 = relu2; P.residual = residual;
  P.td = td; P.th = th; P.tw = tw;
  P.nd = (D + td - 1) / td;
  P.nh = (H + th - 1) / th;
  P.nw = (W + tw - 1) / tw;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (Cout == 1) return launch<__nv_bfloat16, 1>(P, s);
    return launch<__nv_bfloat16, 32>(P, s);
  }
  if (Cout == 1) return launch<float, 1>(P, s);
  return launch<float, 32>(P, s);
}
