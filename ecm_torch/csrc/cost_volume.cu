// Concat and correlation cost volumes for Hopper (sm_90a).
//
// Concat. Replaces: ecm_tpu/ops/pallas_cost_volume.py, _concat_fwd_kernel
// (the pallas_call in _concat_fwd), reached through
// cost_volume_pallas(mode="concat").
//
// Computes, for fl, fr [B, H, W, C] and out [B, D, H, W, 2C]:
//   out[b, d, h, w, :C]  = w >= d ? fl[b, h, w, :]     : 0
//   out[b, d, h, w, C:]  = w >= d ? fr[b, h, w - d, :] : 0
//
// Bound on the H100: pure data movement. Each output byte is written once
// (184.0 MB at B=1, 48x96x312, 2C=64 bf16) and the inputs are read once
// (3.8 MB); no arithmetic. So the floor is bytes / 3.35 TB/s.
//
// Design: one thread per 16-byte chunk of a 2C channel row (or the widest
// unit that divides the row, for odd widths), so the 32 threads of a warp
// store 512 consecutive bytes and every store is a full, coalesced 16-byte
// vector store. The reads come from the small inputs, which stay in L2 while
// all D planes are written. Values are copied bit for bit, zeros are written
// as +0, so the result is identical to the plain builder.
//
// Correlation. Replaces: ecm_tpu/ops/pallas_cost_volume.py, _corr_fwd_kernel
// (the pallas_call in _corr_fwd), reached through
// cost_volume_pallas(mode="correlation"). Computes, for fl, fr [B, H, W, C]
// and out [B, D, H, W] (the [B, D, H, W, 1] volume):
//   out[b, d, h, w] = w >= d ? sum_c fl[b, h, w, c] * fr[b, h, w - d, c] / C : 0
// with products and sum in f32, rounded once at the store.
//
// Bound on the H100: bytes. At B=1, 96x312, C=32, D=48 in bf16 it reads
// 3.8 MB and writes 2.9 MB (about 2 us at 3.35 TB/s) for 46 M multiply-adds
// (1.4 us on the CUDA cores at 67 TFLOP/s f32).
//
// Design: one block per (b, h) row and chunk of kCorrD disparities (6
// blocks a row at D=48, so that enough blocks are in flight to hide the
// latency of the row loads). The block reads the two feature rows once,
// into shared memory as f32 with a row pitch of C + 1 words (so the 32
// threads of a warp, on 32 neighbouring columns, hit 32 different banks),
// then sweeps its (d, w) with w fastest: every warp writes 32 neighbouring
// outputs of one plane. Global memory sees each row D / kCorrD times (from
// L2 after the first), not D times.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

template <typename U>
__global__ void concat_kernel(const U* __restrict__ fl, const U* __restrict__ fr,
                              U* __restrict__ out, int64_t total, int H, int W,
                              int D, int units_c) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  // i enumerates (b, d, h, w, unit) with unit in [0, 2 * units_c)
  const int two_u = 2 * units_c;
  const int unit = (int)(i % two_u);
  int64_t r = i / two_u;
  const int w = (int)(r % W);
  r /= W;
  const int h = (int)(r % H);
  r /= H;
  const int d = (int)(r % D);
  const int64_t b = r / D;
  U v;
  if (w < d) {
    v = U{};
  } else if (unit < units_c) {
    v = fl[((b * H + h) * W + w) * units_c + unit];
  } else {
    v = fr[((b * H + h) * W + (w - d)) * units_c + (unit - units_c)];
  }
  out[i] = v;
}

template <typename U>
cudaError_t launch(const void* fl, const void* fr, void* out, int B, int H,
                   int W, int row_bytes, int D, cudaStream_t stream) {
  const int units_c = row_bytes / (int)sizeof(U);
  const int64_t total = (int64_t)B * D * H * W * 2 * units_c;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  concat_kernel<U><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const U*>(fl), static_cast<const U*>(fr), static_cast<U*>(out),
      total, H, W, D, units_c);
  return cudaGetLastError();
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

constexpr int kCorrThreads = 256;
constexpr int kCorrD = 8;  // disparities per block

template <typename T>
__global__ void __launch_bounds__(kCorrThreads)
    correlation_kernel(const T* __restrict__ fl, const T* __restrict__ fr, T* __restrict__ out,
                       int H, int W, int C, int D) {
  extern __shared__ float rows[];  // [2][W][C + 1]: fl row, then fr row
  const int pitch = C + 1;
  float* sl = rows;
  float* sr = rows + (size_t)W * pitch;
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H, h = bh % H;
  const int d0 = blockIdx.y * kCorrD, nd = min(kCorrD, D - d0);
  const T* gl = fl + (size_t)bh * W * C;
  const T* gr = fr + (size_t)bh * W * C;
  for (int i = threadIdx.x; i < W * C; i += kCorrThreads) {
    const int w = i / C, c = i % C;
    sl[w * pitch + c] = to_f32(gl[i]);
    sr[w * pitch + c] = to_f32(gr[i]);
  }
  __syncthreads();
  const float inv_c = 1.0f / (float)C;
  for (int i = threadIdx.x; i < nd * W; i += kCorrThreads) {
    const int d = d0 + i / W, w = i % W;
    float acc = 0.f;
    if (w >= d) {
      const float* a = sl + w * pitch;
      const float* r = sr + (w - d) * pitch;
      for (int c = 0; c < C; ++c) acc = fmaf(a[c], r[c], acc);
      acc *= inv_c;
    }
    store(out + (((size_t)b * D + d) * H + h) * W + w, acc);
  }
}

template <typename T>
cudaError_t launch_correlation(const void* fl, const void* fr, void* out, int B, int H, int W,
                               int C, int D, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)W * (C + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        correlation_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((unsigned)((size_t)B * H), (D + kCorrD - 1) / kCorrD);
  correlation_kernel<T><<<grid, kCorrThreads, smem, stream>>>(
      static_cast<const T*>(fl), static_cast<const T*>(fr), static_cast<T*>(out), H, W, C, D);
  return cudaGetLastError();
}

}  // namespace

// Correlation volume. dtype: 0 = float32, 1 = bfloat16 (fl, fr and out).
// out is [B, D, H, W]. Needs 2 * W * (C + 1) * 4 bytes of shared memory
// (at most 227 KB).
extern "C" int ecm_cost_volume_correlation(int dtype, const void* fl, const void* fr, void* out,
                                           int B, int H, int W, int C, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_correlation<__nv_bfloat16>(fl, fr, out, B, H, W, C, D, s);
  return launch_correlation<float>(fl, fr, out, B, H, W, C, D, s);
}

// row_bytes = C * element size. All pointers must be 16-byte aligned.
extern "C" int ecm_cost_volume_concat(const void* fl, const void* fr, void* out,
                                      int B, int H, int W, int row_bytes, int D,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (row_bytes % 16 == 0) return launch<uint4>(fl, fr, out, B, H, W, row_bytes, D, s);
  if (row_bytes % 8 == 0) return launch<uint2>(fl, fr, out, B, H, W, row_bytes, D, s);
  if (row_bytes % 4 == 0) return launch<uint32_t>(fl, fr, out, B, H, W, row_bytes, D, s);
  if (row_bytes % 2 == 0) return launch<uint16_t>(fl, fr, out, B, H, W, row_bytes, D, s);
  return launch<uint8_t>(fl, fr, out, B, H, W, row_bytes, D, s);
}
