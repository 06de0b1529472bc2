// Fused x4 trilinear upsample + soft-argmin for Hopper (sm_90a).
//
// Replaces: ecm_tpu/ops/pallas_regression.py, _regression_kernel (the
// pallas_call in fused_upsample_softargmin).
//
// Computes, for a quarter-resolution cost map c4 [B, D4, H4, W4] (bf16 or
// f32, widened to f32 in registers), the disparity [B, 4*H4, 4*W4] (f32) of
//   softmax_d(-up(c4))  with  disp = sum_d d * p_d,  d in [0, 4*D4),
// where up() is the half-pixel-centre, edge-clamped linear resize by 4 along
// D, H and W (output index 4i+p reads source i-1/i for p < 2 and i/i+1 for
// p >= 2, right-neighbour fractions 0.625, 0.875, 0.125, 0.375). The full
// resolution volume [B, 4*D4, 4*H4, 4*W4] never exists.
//
// Bound on the H100: the exponentials. One per full-resolution cost value
// (92.0 M at B=1, 384x1248, D=192) on the SFU's 16 results per clock per SM;
// the bytes (one read of c4, one write of the map, ~4.8 MB) take a fraction
// of that.
//
// Design: one thread per output pixel; a block covers 128 consecutive pixels
// of one output row, so neighbouring threads read neighbouring low-res
// columns. Each thread first mixes its 2x2 low-res neighbours in H and W for
// all D4 planes into shared memory (plane-major, so the accesses of a warp
// fall on distinct banks), then makes two passes over the 4*D4 D-upsampled
// values: the exact minimum (the stable softmax shift), then the sums
// sum exp(m - c) and sum exp(m - c) * d in f32.

#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
__constant__ float kFrac[4] = {0.625f, 0.875f, 0.125f, 0.375f};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Source pair and right-neighbour fraction of output index o (scale 4).
__device__ __forceinline__ void src_pair(int o, int n, int& lo, int& hi, float& f) {
  const int i = o >> 2, p = o & 3;
  lo = p < 2 ? i - 1 : i;
  hi = lo + 1;
  lo = max(0, min(lo, n - 1));
  hi = max(0, min(hi, n - 1));
  f = kFrac[p];
}

template <typename T>
__global__ void upsample_softargmin_kernel(const T* __restrict__ c4,
                                           float* __restrict__ out, int D4,
                                           int H4, int W4) {
  extern __shared__ float v[];  // [D4][kThreads]
  const int W = 4 * W4;
  const int x = blockIdx.x * kThreads + threadIdx.x;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  if (x >= W) return;  // no barrier follows: each thread owns its column of v

  int y0, y1, x0, x1;
  float fy, fx;
  src_pair(y, H4, y0, y1, fy);
  src_pair(x, W4, x0, x1, fx);
  const size_t plane = (size_t)H4 * W4;
  const T* base = c4 + (size_t)b * D4 * plane;
  for (int i = 0; i < D4; ++i) {
    const T* p = base + i * plane;
    const float a = (1.f - fx) * to_f32(p[y0 * W4 + x0]) + fx * to_f32(p[y0 * W4 + x1]);
    const float c = (1.f - fx) * to_f32(p[y1 * W4 + x0]) + fx * to_f32(p[y1 * W4 + x1]);
    v[i * kThreads + threadIdx.x] = (1.f - fy) * a + fy * c;
  }

  const int D = 4 * D4;
  float m = INFINITY;
  for (int d = 0; d < D; ++d) {
    int lo, hi;
    float f;
    src_pair(d, D4, lo, hi, f);
    const float c = (1.f - f) * v[lo * kThreads + threadIdx.x] + f * v[hi * kThreads + threadIdx.x];
    m = fminf(m, c);
  }
  float den = 0.f, num = 0.f;
  for (int d = 0; d < D; ++d) {
    int lo, hi;
    float f;
    src_pair(d, D4, lo, hi, f);
    const float c = (1.f - f) * v[lo * kThreads + threadIdx.x] + f * v[hi * kThreads + threadIdx.x];
    const float e = expf(m - c);
    den += e;
    num += e * (float)d;
  }
  out[((size_t)b * 4 * H4 + y) * W + x] = num / den;
}

template <typename T>
cudaError_t launch(const void* c4, float* out, int B, int D4, int H4, int W4,
                   cudaStream_t stream) {
  const size_t smem = (size_t)D4 * kThreads * sizeof(float);
  auto kernel = upsample_softargmin_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((4 * W4 + kThreads - 1) / kThreads, 4 * H4, B);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(c4), out, D4, H4, W4);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. out is float32 [B, 4*H4, 4*W4].
extern "C" int ecm_upsample_softargmin(int dtype, const void* c4, void* out,
                                       int B, int D4, int H4, int W4,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == 1) return launch<__nv_bfloat16>(c4, o, B, D4, H4, W4, s);
  return launch<float>(c4, o, B, D4, H4, W4, s);
}
