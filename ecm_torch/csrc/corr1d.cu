// Lookup of RAFT-Stereo's 1-D correlation pyramid for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no RAFT-Stereo. It serves the
// port's models/raft_stereo.py, whose every update iteration samples the
// all-pairs correlation pyramid at fractional positions that the previous
// iteration moved (published CorrBlock1D with grid_sample, one call a level).
//
// For level i of L (a row of width W_i = W2 >> i per pixel), pixel
// n = (b, h, x1) and tap t in 0..2R (offset k = t - R), with
// x = coords[b, 0, h, x1] * 2^-i + k, x0 = floor(x):
//   out[b, i * (2R + 1) + t, h, x1] = v(x0) * (x0 + 1 - x) + v(x0 + 1) * (x - x0),
//   v(p) = corr_i[n, p] for 0 <= p < W_i, else 0
// (grid_sample, bilinear, align_corners=True, zero padding: at x = -0.5 the
// value is 0.5 * corr_i[n, 0]). Channels are level-major, tap-minor; the
// output is NCHW, in float32, float16 or bfloat16 (what the next 1x1 conv
// reads).
//
// Bound on the H100: bytes. At B = 1, 96 x 312 pixels, L = 4, R = 4 a
// lookup reads each pixel's x coordinate and its 2R + 2 neighbouring values
// of each level (7.1 MB with the 2.2 MB of float16 output), ~2.1 us at
// 3.35 TB/s, next to a launch's own few microseconds. So the design keeps
// every thread's loads independent and in flight together:
//   - a thread per (pixel, level): 4 x 29952 threads, a level per blockIdx.y,
//     consecutive threads on consecutive x1, so every store is coalesced;
//   - each tap's two values are loaded at clamped addresses and zeroed out
//     of range by a select, so the loads carry no branch and the bytes a
//     lookup moves do not depend on the coordinates; a tap's right value is
//     the next tap's left one, which L1 serves;
//   - x is computed per tap as the published lookup does (coords * 2^-i,
//     then + k, each rounded to float32), so no tap's floor can differ from
//     it by the rounding of a shared base.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 4;

struct Levels {
  const float* ptr[kMaxLevels];  // level i: [n_pix, width[i]] float32, contiguous
  int width[kMaxLevels];
  float scale[kMaxLevels];  // 2^-i
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__half* p, float v) { *p = __float2half_rn(v); }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <int R, typename T>
__global__ void __launch_bounds__(kThreads)
    corr1d_lookup_kernel(Levels lv, const float* __restrict__ coords, T* __restrict__ out,
                         int n_pix, int hw, int channels) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= n_pix) return;
  const int level = blockIdx.y;
  const int b = n / hw, s = n - b * hw;
  const int wi = lv.width[level];
  const float* __restrict__ row = lv.ptr[level] + (size_t)n * wi;
  const float c = __fmul_rn(__ldg(coords + (size_t)b * 2 * hw + s), lv.scale[level]);
  float lo[2 * R + 1], hi[2 * R + 1], x[2 * R + 1];
  int x0[2 * R + 1];
#pragma unroll
  for (int t = 0; t < 2 * R + 1; ++t) {
    x[t] = __fadd_rn(c, (float)(t - R));
    // floor, saturated (NaN -> 0), then kept in [-2, wi] so that x0 + 1
    // cannot overflow: a clamped tap has both neighbours out of range
    x0[t] = min(max(__float2int_rd(x[t]), -2), wi);
    const int a = x0[t], e = x0[t] + 1;
    const float va = __ldg(row + min(max(a, 0), wi - 1));
    const float ve = __ldg(row + min(max(e, 0), wi - 1));
    lo[t] = (a >= 0 && a < wi) ? va : 0.f;
    hi[t] = (e >= 0 && e < wi) ? ve : 0.f;
  }
  T* o = out + ((size_t)b * channels + level * (2 * R + 1)) * hw + s;
#pragma unroll
  for (int t = 0; t < 2 * R + 1; ++t) {
    const float f = (float)x0[t];
    const float w_hi = __fsub_rn(x[t], f), w_lo = __fsub_rn(__fadd_rn(f, 1.f), x[t]);
    store(o + (size_t)t * hw, __fadd_rn(__fmul_rn(lo[t], w_lo), __fmul_rn(hi[t], w_hi)));
  }
}

template <typename T>
cudaError_t launch(const Levels& lv, int levels, const float* coords, void* out, int n_pix, int hw,
                   cudaStream_t stream) {
  constexpr int R = 4;
  const dim3 grid((n_pix + kThreads - 1) / kThreads, levels);
  corr1d_lookup_kernel<R, T><<<grid, kThreads, 0, stream>>>(lv, coords, static_cast<T*>(out), n_pix, hw,
                                                            levels * (2 * R + 1));
  return cudaGetLastError();
}

}  // namespace

// out_dtype: 0 = float32, 1 = float16, 2 = bfloat16. levels: 1..4 pointers (the rest
// null), level i a contiguous float32 [B*H*W1, W2 >> i]; coords a contiguous
// float32 [B, 2, H, W1] (channel 0 is x); out [B, levels * 9, H, W1]. Only
// radius 4 is built, else cudaErrorInvalidValue.
extern "C" int ecm_corr1d_lookup(int out_dtype, int levels, const void* l0, const void* l1, const void* l2,
                                 const void* l3, const void* coords, void* out, int B, int H, int W1, int W2,
                                 int radius, void* stream) {
  if (radius != 4 || levels < 1 || levels > kMaxLevels || (W2 >> (levels - 1)) < 1)
    return cudaErrorInvalidValue;
  Levels lv = {};
  const void* ptrs[kMaxLevels] = {l0, l1, l2, l3};
  for (int i = 0; i < levels; ++i) {
    lv.ptr[i] = static_cast<const float*>(ptrs[i]);
    lv.width[i] = W2 >> i;
    lv.scale[i] = 1.f / (float)(1 << i);
  }
  const int hw = H * W1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(coords);
  if (out_dtype == 1) return launch<__half>(lv, levels, c, out, B * hw, hw, s);
  if (out_dtype == 2) return launch<__nv_bfloat16>(lv, levels, c, out, B * hw, hw, s);
  return launch<float>(lv, levels, c, out, B * hw, hw, s);
}
