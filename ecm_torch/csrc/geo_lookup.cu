// IGEV-Stereo's combined geometry-encoding lookup for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no IGEV-Stereo. It serves the
// port's models/igev_stereo.py, whose every update iteration samples two
// pyramids at the disparity the previous iteration left (published
// Combined_Geo_Encoding_Volume, grid_sample twice a level): the geometry
// encoding volume, C = 8 channels of D disparities a pixel, along d, and the
// all-pairs correlation of the matching features, a row of W2 a pixel,
// along the right image's column.
//
// For level i of L (geometry D_i = D >> i planes, correlation W_i = W2 >> i
// columns), pixel n = (b, h, x), disparity delta = disp[b, h, x] (1/4 scale),
// channel c < C, tap t in 0..2R (offset k = t - R):
//   geo: u = delta * 2^-i + k,             out = lin(G_i[n, :, c], u)
//   cor: u = (x * 2^-i - delta * 2^-i) + k, out = lin(C_i[n, :], u)
//   lin(v, u) = v(u0) * (u0 + 1 - u) + v(u0 + 1) * (u - u0), u0 = floor(u),
//   v(p) = 0 outside the row
// (grid_sample, bilinear, align_corners=True, zero padding). A pixel's
// L * (C + 1) * (2R + 1) outputs (162 at L = 2, C = 8, R = 4) are level-major,
// then [geo channel 0 .. C - 1, cor], then tap: the published channel order
// [geo_0 (c-major, k-minor), cor_0, geo_1, cor_1]. The output is
// channels-last, [B, H, W, 162], in float32, float16 or bfloat16: what the
// next 1x1 conv reads, with no transpose.
//
// Bound on the H100: bytes. At B = 1, 96 x 312 pixels, L = 2, R = 4 a lookup
// reads each pixel's disparity (4 B), per level the 2R + 2 values of each of
// the C geometry channels and of the correlation row that its taps touch
// (9 x 40 B), and writes 162 float16 outputs (324 B): ~1,048 B a pixel,
// 31.4 MB, ~9.4 us at 3.35 TB/s. So the design keeps the loads independent
// and coalesced and the stores whole:
//   - a thread per (pixel, level, row), a row being one geometry channel or
//     the correlation: 18 threads a pixel, 32 pixels a block. The geometry
//     levels are float32 [pixels, D_i, C], so the C threads of a pixel's
//     level read C neighbouring floats (one 32-byte sector) at each plane;
//   - each tap's two values are loaded at clamped addresses and zeroed out
//     of range by a select, so no load waits on a branch and the bytes a
//     lookup moves do not depend on the disparities;
//   - u is computed per tap as the published lookup does (delta * 2^-i,
//     then + k, each rounded to float32), as in corr1d.cu;
//   - each thread rounds its 2R + 1 values into a shared tile of the
//     block's 32 pixels x 162 channels, which the block then stores in
//     16-byte vectors: 32 pixels' outputs are one contiguous span whose
//     size and start are multiples of 16 bytes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kC = 8;         // geometry channels
constexpr int kR = 4;         // radius
constexpr int kTaps = 2 * kR + 1;
constexpr int kMaxLevels = 2;
constexpr int kPix = 32;      // pixels a block
constexpr int kMaxRows = kMaxLevels * (kC + 1);
constexpr int kMaxThreads = kPix * kMaxRows;

struct Pyramids {
  const float* geo[kMaxLevels];   // level i: [n_pix, depth[i], kC] float32, contiguous
  const float* corr[kMaxLevels];  // level i: [n_pix, width[i]] float32, contiguous
  int depth[kMaxLevels];
  int width[kMaxLevels];
  float scale[kMaxLevels];  // 2^-i
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__half* p, float v) { *p = __float2half_rn(v); }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    geo_lookup_kernel(Pyramids py, const float* __restrict__ disp, T* __restrict__ out, int n_pix, int W,
                      int levels) {
  __shared__ __align__(16) T tile[kPix * kMaxRows * kTaps];
  const int rows = levels * (kC + 1), channels = rows * kTaps;
  const int p = threadIdx.x / rows, j = threadIdx.x - p * rows;
  const int n0 = blockIdx.x * kPix, n = n0 + p;
  const int level = j / (kC + 1), r = j - level * (kC + 1);  // r < kC: geometry channel r; kC: correlation
  if (n < n_pix) {
    const float s = py.scale[level];
    const float dl = __fmul_rn(__ldg(disp + n), s);
    const bool geo = r < kC;
    const int len = geo ? py.depth[level] : py.width[level];
    const int stride = geo ? kC : 1;
    const float* __restrict__ row =
        geo ? py.geo[level] + (size_t)n * len * kC + r : py.corr[level] + (size_t)n * len;
    const float base = geo ? dl : __fsub_rn(__fmul_rn((float)(n % W), s), dl);
    float lo[kTaps], hi[kTaps], u[kTaps];
    int u0[kTaps];
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      u[t] = __fadd_rn(base, (float)(t - kR));
      // floor, saturated (NaN -> 0), then kept in [-2, len] so that u0 + 1
      // cannot overflow: a clamped tap has both neighbours out of range
      u0[t] = min(max(__float2int_rd(u[t]), -2), len);
      const int a = u0[t], e = u0[t] + 1;
      const float va = __ldg(row + (size_t)min(max(a, 0), len - 1) * stride);
      const float ve = __ldg(row + (size_t)min(max(e, 0), len - 1) * stride);
      lo[t] = (a >= 0 && a < len) ? va : 0.f;
      hi[t] = (e >= 0 && e < len) ? ve : 0.f;
    }
    T* o = tile + p * channels + j * kTaps;
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      const float f = (float)u0[t];
      const float w_hi = __fsub_rn(u[t], f), w_lo = __fsub_rn(__fadd_rn(f, 1.f), u[t]);
      store(o + t, __fadd_rn(__fmul_rn(lo[t], w_lo), __fmul_rn(hi[t], w_hi)));
    }
  }
  __syncthreads();
  // the block's pixels' outputs, one contiguous span of out starting at a
  // multiple of 16 bytes (kPix * channels * sizeof(T) is one)
  const int elems = min(kPix, n_pix - n0) * channels;
  const int vecs = elems * (int)sizeof(T) / 16;
  uint4* dst = reinterpret_cast<uint4*>(out + (size_t)n0 * channels);
  const uint4* src = reinterpret_cast<const uint4*>(tile);
  for (int k = threadIdx.x; k < vecs; k += blockDim.x) dst[k] = src[k];
  for (int k = vecs * 16 / (int)sizeof(T) + threadIdx.x; k < elems; k += blockDim.x)
    out[(size_t)n0 * channels + k] = tile[k];
}

template <typename T>
cudaError_t launch(const Pyramids& py, int levels, const float* disp, void* out, int n_pix, int W,
                   cudaStream_t stream) {
  const int threads = kPix * levels * (kC + 1);
  geo_lookup_kernel<T><<<(n_pix + kPix - 1) / kPix, threads, 0, stream>>>(py, disp, static_cast<T*>(out), n_pix,
                                                                          W, levels);
  return cudaGetLastError();
}

}  // namespace

// out_dtype: 0 = float32, 1 = float16, 2 = bfloat16. levels 1..2: geometry
// level i a contiguous float32 [B*H*W, D >> i, 8], correlation level i a
// contiguous float32 [B*H*W, W2 >> i] (unused pointers null); disp a
// contiguous float32 [B, H, W] at 1/4 scale; out a 16-byte aligned
// [B, H, W, levels * 9 * 9]. Only C = 8 and radius 4 are built, else
// cudaErrorInvalidValue.
extern "C" int ecm_geo_lookup(int out_dtype, int levels, const void* g0, const void* g1, const void* c0,
                              const void* c1, const void* disp, void* out, int B, int H, int W, int D, int C,
                              int W2, int radius, void* stream) {
  if (C != kC || radius != kR || levels < 1 || levels > kMaxLevels || (D >> (levels - 1)) < 1 ||
      (W2 >> (levels - 1)) < 1)
    return cudaErrorInvalidValue;
  Pyramids py = {};
  const void* geo[kMaxLevels] = {g0, g1};
  const void* corr[kMaxLevels] = {c0, c1};
  for (int i = 0; i < levels; ++i) {
    py.geo[i] = static_cast<const float*>(geo[i]);
    py.corr[i] = static_cast<const float*>(corr[i]);
    py.depth[i] = D >> i;
    py.width[i] = W2 >> i;
    py.scale[i] = 1.f / (float)(1 << i);
  }
  const int n_pix = B * H * W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(disp);
  if (out_dtype == 1) return launch<__half>(py, levels, d, out, n_pix, W, s);
  if (out_dtype == 2) return launch<__nv_bfloat16>(py, levels, d, out, n_pix, W, s);
  return launch<float>(py, levels, d, out, n_pix, W, s);
}
