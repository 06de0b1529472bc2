// Fused x4 trilinear upsample + soft-argmin for Hopper (sm_90a).
//
// Replaces: ecm_tpu/ops/pallas_regression.py, _regression_kernel (the
// pallas_call in fused_upsample_softargmin).
//
// Computes, for a quarter-resolution cost map c4 [B, D4, H4, W4] (bf16 or
// f32, widened to f32), the disparity [B, 4*H4, 4*W4] (f32) of
//   softmax_d(-up(c4))  with  disp = sum_d d * p_d,  d in [0, 4*D4),
// where up() is the half-pixel-centre, edge-clamped linear resize by 4 along
// D, H and W (output index 4i+p reads source i-1/i for p < 2 and i/i+1 for
// p >= 2, right-neighbour fractions 0.625, 0.875, 0.125, 0.375). The full
// resolution volume [B, 4*D4, 4*H4, 4*W4] never exists.
//
// Bound on the H100: the exponentials. One per full-resolution cost value
// (92.0 M at B=1, 384x1248, D=192) on the SFU's 16 results per clock per SM;
// the bytes (one read of c4, one write of the map, ~4.8 MB) take a fraction
// of that. So the design spends one MUFU op (ex2) per value, plus one per
// low-res plane pair for the shift, and four FP32 instructions per value;
// the shared-memory loads per value stay well below one.
//
// Design. A block takes one low-res row r of one batch entry and a tile of
// tw low-res columns (tw a multiple of 8, so 4*tw threads are whole warps;
// the wrapper's plan picks a tw with no idle thread where W4 allows). It
// stages the three low-res rows r-1, r, r+1 (clamped) of every plane, the
// tile and one clamped column on each side, into shared memory as f32
// scaled by log2(e), each value read from device memory once per block,
// kStage loads of a warp in flight at a time.
// Thread (p, x) owns output row 4r+p and the four output columns 4x..4x+3:
// per plane it mixes its row pair at fy (3 lerps), then its two column
// pairs at the four W fractions, so the H/W mix of a neighbourhood is done
// once for four outputs. One pass over the planes follows, holding only
// the previous plane's value per output in registers (an online softmax):
//   - the shift m is the running minimum of every value produced so far. A
//     lerp computed as fma(f, b - a, a) rounds monotonically in f, so the
//     minimum of the four D phases between planes i and i+1 is at f = 0.125
//     or 0.875; the pair's minimum enters m before its values are
//     exponentiated, and den and num are rescaled by ex2(m_old - m_new) <= 1;
//   - den = sum ex2(m - c), num = sum d ex2(m - c), with c computed by the
//     same expression that set m: the minimum gives ex2(0) = 1, so den >= 1
//     and costs of any finite size (1e8 at random init) give no overflow and
//     no NaN.
// All lerps use explicit __f*_rn intrinsics so the shift and the values
// round alike.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kStage = 8;  // staged lines a warp loads at a time

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// a + f (b - a), rounded the same way wherever it is written
__device__ __forceinline__ float lerp(float a, float b, float f) {
  return __fmaf_rn(f, __fsub_rn(b, a), a);
}

// fraction of output phase p (scale 4)
__device__ __forceinline__ float frac(int p) {
  return p == 0 ? 0.625f : p == 1 ? 0.875f : p == 2 ? 0.125f : 0.375f;
}

// The four outputs' values at one plane: row pair (ra, rb) at fy, then
// columns (x-1, x) at 0.625/0.875 and (x, x+1) at 0.125/0.375.
__device__ __forceinline__ void plane_values(const float* __restrict__ ra,
                                             const float* __restrict__ rb, float fy,
                                             float (&u)[4]) {
  const float h0 = lerp(ra[0], rb[0], fy);
  const float h1 = lerp(ra[1], rb[1], fy);
  const float h2 = lerp(ra[2], rb[2], fy);
  u[0] = lerp(h0, h1, 0.625f);
  u[1] = lerp(h0, h1, 0.875f);
  u[2] = lerp(h1, h2, 0.125f);
  u[3] = lerp(h1, h2, 0.375f);
}

template <typename T>
__global__ void upsample_softargmin_kernel(const T* __restrict__ c4, float* __restrict__ out,
                                           int D4, int H4, int W4, int tw) {
  extern __shared__ float s[];  // [D4][3 rows][tw + 2 columns], log2(e)-scaled
  const int pitch = tw + 2;
  const int x0 = blockIdx.x * tw, r = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const T* base = c4 + (size_t)b * D4 * H4 * W4;
  // (plane, row) lines, kStage per warp at a time: the loads of a batch are
  // in flight together
  for (int l0 = warp * kStage; l0 < 3 * D4; l0 += warps * kStage) {
    for (int j = lane; j < pitch; j += 32) {
      const int col = min(max(x0 - 1 + j, 0), W4 - 1);
      float v[kStage];
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int l = min(l0 + u, 3 * D4 - 1), i = l / 3;
        const int row = min(max(r - 1 + l - 3 * i, 0), H4 - 1);
        v[u] = to_f32(__ldg(base + ((size_t)i * H4 + row) * W4 + col));
      }
#pragma unroll
      for (int u = 0; u < kStage; ++u)
        if (l0 + u < 3 * D4) s[(l0 + u) * pitch + j] = v[u] * kLog2e;
    }
  }
  __syncthreads();

  const int p = threadIdx.x / tw, xl = threadIdx.x - p * tw, x = x0 + xl;
  if (x >= W4) return;  // no barrier follows
  const float fy = frac(p);
  // this thread's row pair (rows 0, 1, 2 of a plane are r-1, r, r+1) and
  // its three columns x-1, x, x+1 (shared columns xl .. xl+2)
  const float* ra = s + (p < 2 ? 0 : 1) * pitch + xl;
  const float* rb = ra + pitch;
  const int plane = 3 * pitch;

  // one pass: the running shift m is the minimum of every value so far; a
  // pair's minimum is at f = 0.125 or 0.875, taken before its values are
  // exponentiated, and den, num rescale by ex2(m_old - m_new) <= 1
  float prev[4], cur[4], m[4], den[4], num[4];
  plane_values(ra, rb, fy, prev);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    m[k] = prev[k];
    den[k] = 2.f;  // d = 0 and 1: ex2(0)
    num[k] = 1.f;
  }
  float dbase = 2.f;
  for (int i = 1; i < D4; ++i) {
    plane_values(ra + i * plane, rb + i * plane, fy, cur);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float d = __fsub_rn(cur[k], prev[k]);
      float c[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = __fmaf_rn(0.125f + 0.25f * j, d, prev[k]);
      const float mn = fminf(m[k], fminf(c[0], c[3]));
      const float scale = ex2(__fsub_rn(mn, m[k]));
      den[k] *= scale;
      num[k] *= scale;
      m[k] = mn;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = ex2(__fsub_rn(mn, c[j]));
        den[k] += e;
        num[k] = __fmaf_rn(e, dbase + (float)j, num[k]);
      }
      prev[k] = cur[k];
    }
    dbase += 4.f;
  }
  // d = 4 D4 - 2, 4 D4 - 1: the last plane's value
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float mn = fminf(m[k], prev[k]);
    const float scale = ex2(__fsub_rn(mn, m[k]));
    den[k] *= scale;
    num[k] *= scale;
    m[k] = mn;
  }
  float4 o;
  float* ov = &o.x;
  const float last = (float)(8 * D4 - 3);  // (4 D4 - 2) + (4 D4 - 1)
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float e = ex2(__fsub_rn(m[k], prev[k]));
    ov[k] = __fmaf_rn(e, last, num[k]) / (den[k] + 2.f * e);
  }
  *reinterpret_cast<float4*>(out + ((size_t)b * 4 * H4 + 4 * r + p) * (4 * W4) + 4 * x) = o;
}

template <typename T>
cudaError_t launch(const void* c4, float* out, int B, int D4, int H4, int W4, int tw,
                   size_t smem, cudaStream_t stream) {
  auto kernel = upsample_softargmin_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((W4 + tw - 1) / tw, H4, B);
  kernel<<<grid, 4 * tw, smem, stream>>>(static_cast<const T*>(c4), out, D4, H4, W4, tw);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. out is float32 [B, 4*H4, 4*W4], 16-byte
// aligned. tw (a multiple of 8, at most 256) and smem_bytes come from the
// wrapper's plan (cuda_regression.regression_plan); smem_bytes must be
// D4 * 3 * (tw + 2) * 4, else cudaErrorInvalidValue.
extern "C" int ecm_upsample_softargmin(int dtype, const void* c4, void* out, int B, int D4, int H4,
                                       int W4, int tw, int smem_bytes, void* stream) {
  const size_t smem = (size_t)D4 * 3 * (tw + 2) * sizeof(float);
  if (tw <= 0 || tw % 8 || tw > 256 || (size_t)smem_bytes != smem) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == 1) return launch<__nv_bfloat16>(c4, o, B, D4, H4, W4, tw, smem, s);
  return launch<float>(c4, o, B, D4, H4, W4, tw, smem, s);
}
