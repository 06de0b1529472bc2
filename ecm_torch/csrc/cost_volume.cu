// Concat and correlation cost volumes for Hopper (sm_90a).
//
// Concat. Replaces: ecm_tpu/ops/pallas_cost_volume.py, _concat_fwd_kernel
// (the pallas_call in _concat_fwd), reached through
// cost_volume_pallas(mode="concat").
//
// Computes, for fl, fr [B, H, W, C] and out [B, D, H, W, 2C], plane i at
// disparity d = d_start + i (d_start = 0 for the whole volume; a rank of a
// disparity-sharded forward builds its own range of planes):
//   out[b, i, h, w, :C]  = w >= d ? fl[b, h, w, :]     : 0
//   out[b, i, h, w, C:]  = w >= d ? fr[b, h, w - d, :] : 0
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
// and out [B, D, H, W, G] (G groups of Cg = C / G channels; ECM's volume is
// G = 1), plane i at disparity d = d_start + i:
//   out[b, i, h, w, g] = w >= d ? sum_{c in group g} fl[b, h, w, c] * fr[b, h, w - d, c] / Cg : 0
// with products and sum in f32, rounded once at the store. G > 1 is
// IGEV-Stereo's group-wise volume (8 groups of 12 channels), which no TPU
// kernel has: each group is a block of its own (blockIdx.z), staging only
// its group's channels, so G = 1 is ECM's launch and arithmetic unchanged.
//
// Bound on the H100: bytes. At B=1, 96x312, C=32, D=48 in bf16 it reads
// 3.8 MB and writes 2.9 MB (about 2 us at 3.35 TB/s) for 46 M multiply-adds
// (1.4 us on the CUDA cores at 67 TFLOP/s f32).
//
// Design: a block per (b, h) row, group and tile of kCorrW = 64 columns,
// with all D disparities of those columns, so each feature row is read from device
// memory once (plus a halo of D columns of fr). The block stages fr's
// columns w0 - d_start - D .. w0 - d_start + 64 and fl's w0 .. w0 + 63 into shared memory as
// f32, in coalesced 16-byte loads (zero outside the image, channels padded
// with zeros to CP, a power of 2), even columns before odd ones, row pitch
// CP + 2 words (an odd number of 8-byte units). Its 128 threads are
// kCorrGroups = 4 groups of 32; thread (g, l) owns the two columns w0 + 2l
// and w0 + 2l + 1, holds both fl rows in registers (f32), and walks the
// D / 4 + 1 fr rows of its thread group's D / 4 planes (fr's columns are staged from
// w0 - d_start - D, so the plane offsets below are those of d_start = 0):
// fr row s is fr[(w + 1) - d] for column w + 1 and fr[w - (d - 1)] for column w, so each
// float2 shared load feeds four FMAs, and a warp's 32 threads read 32
// neighbouring rows of one parity, 16 distinct bank pairs per half warp.
// Sums in f32 (two per column), scaled by 1/Cg and rounded once at the
// store; the zero channels add +0. A column's G outputs are G neighbouring
// values, written by G blocks.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

template <typename U>
__global__ void concat_kernel(const U* __restrict__ fl, const U* __restrict__ fr,
                              U* __restrict__ out, int64_t total, int H, int W,
                              int D, int d_start, int units_c) {
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
  const int d = d_start + (int)(r % D);
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
                   int W, int row_bytes, int D, int d_start, cudaStream_t stream) {
  const int units_c = row_bytes / (int)sizeof(U);
  const int64_t total = (int64_t)B * D * H * W * 2 * units_c;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  concat_kernel<U><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const U*>(fl), static_cast<const U*>(fr), static_cast<U*>(out),
      total, H, W, D, d_start, units_c);
  return cudaGetLastError();
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store(__half* p, float v) { *p = __float2half_rn(v); }

constexpr int kCorrW = 64;       // columns per block, two a thread
constexpr int kCorrGroups = 4;   // disparity groups per block
constexpr int kCorrThreads = kCorrW / 2 * kCorrGroups;

// Stage feature columns first .. first + n - 1 of one row (a pixel's
// channels C apart, Cg of them from ``row``) into shared memory as f32 rows
// of CP + 2 words, zero outside [0, W) and in the channels from Cg to CP,
// even columns (j = 0, 2, ..) before odd ones, so that 32 threads on every
// other column read 32 neighbouring rows. Rows of Cg = CP channels go in
// 16-byte loads (CP * sizeof(T) is a multiple of 16, and so is C = G * CP).
template <typename T, int CP>
__device__ __forceinline__ void stage_columns(float* dst, const T* __restrict__ row, int first,
                                              int n, int W, int C, int Cg) {
  constexpr int pitch = CP + 2, V = 16 / sizeof(T), units = CP / V;
  const int half = (n + 1) / 2;
  if (Cg == CP) {
    for (int k = threadIdx.x; k < n * units; k += kCorrThreads) {
      const int j = k / units, u = k % units, col = first + j;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (col >= 0 && col < W) raw = __ldg(reinterpret_cast<const uint4*>(row + (size_t)col * C) + u);
      const T* v = reinterpret_cast<const T*>(&raw);
      float2* o = reinterpret_cast<float2*>(dst + ((j & 1) * half + (j >> 1)) * pitch + u * V);
#pragma unroll
      for (int e = 0; e < V / 2; ++e) o[e] = make_float2(to_f32(v[2 * e]), to_f32(v[2 * e + 1]));
    }
  } else {
    for (int k = threadIdx.x; k < n * CP; k += kCorrThreads) {
      const int j = k / CP, c = k % CP, col = first + j;
      dst[((j & 1) * half + (j >> 1)) * pitch + c] =
          (c < Cg && col >= 0 && col < W) ? to_f32(row[(size_t)col * C + c]) : 0.f;
    }
  }
}

// Both columns' dot products with one staged row, each row pair of
// channels loaded once for four FMAs (two sums per column).
template <int CP>
__device__ __forceinline__ void dot2(const float (&a0)[CP], const float (&a1)[CP],
                                     const float* __restrict__ r, float& v0, float& v1) {
  float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;
#pragma unroll
  for (int c = 0; c < CP; c += 2) {
    const float2 v = *reinterpret_cast<const float2*>(r + c);
    s00 = fmaf(a0[c], v.x, s00);
    s01 = fmaf(a0[c + 1], v.y, s01);
    s10 = fmaf(a1[c], v.x, s10);
    s11 = fmaf(a1[c + 1], v.y, s11);
  }
  v0 = s00 + s01;
  v1 = s10 + s11;
}

template <typename T, int CP>
__global__ void __launch_bounds__(kCorrThreads)
    correlation_kernel(const T* __restrict__ fl, const T* __restrict__ fr, T* __restrict__ out,
                       int H, int W, int C, int D, int d_start, int G) {
  // fr columns w0 - d_start - D .. w0 - d_start + kCorrW (parity-split), then fl columns w0 ..
  // w0 + kCorrW - 1 (parity-split), rows of CP + 2 words
  extern __shared__ float rows[];
  constexpr int pitch = CP + 2;
  const int bh = blockIdx.y;  // b * H + h
  const int b = bh / H, h = bh - b * H;
  const int grp = blockIdx.z, Cg = C / G;  // this block's channels grp * Cg .. + Cg - 1
  const int w0 = blockIdx.x * kCorrW, cols = kCorrW + D + 1, half = (cols + 1) / 2;
  float* lrows = rows + 2 * half * pitch;
  stage_columns<T, CP>(rows, fr + (size_t)bh * W * C + grp * Cg, w0 - d_start - D, cols, W, C, Cg);
  stage_columns<T, CP>(lrows, fl + (size_t)bh * W * C + grp * Cg, w0, kCorrW, W, C, Cg);
  __syncthreads();
  const int l = threadIdx.x % 32, g = threadIdx.x / 32, w = w0 + 2 * l;  // columns w, w + 1
  if (w >= W) return;  // no barrier follows
  float a0[CP], a1[CP];
#pragma unroll
  for (int c = 0; c < CP; c += 2) {
    const float2 v0 = *reinterpret_cast<const float2*>(lrows + l * pitch + c);
    const float2 v1 = *reinterpret_cast<const float2*>(lrows + (kCorrW / 2 + l) * pitch + c);
    a0[c] = v0.x, a0[c + 1] = v0.y, a1[c] = v1.x, a1[c + 1] = v1.y;
  }
  // thread group g: planes d0 .. d1 - 1 of both columns (disparity d_start + d),
  // from the rows s = w + 1 - d_start - d0 - k, k = 0 .. d1 - d0: row k is
  // fr[(w + 1) - (d_start + d0 + k)] and fr[w - (d_start + d0 + k - 1)]
  const int per = (D + kCorrGroups - 1) / kCorrGroups;
  const int d0 = g * per, d1 = min(D, d0 + per);
  const float inv_c = 1.0f / (float)Cg;
  const size_t plane = (size_t)H * W * G;
  T* o = out + (((size_t)b * D * H + h) * W + w) * G + grp;  // + d * plane
  const bool second = w + 1 < W;
#pragma unroll 2
  for (int k = 0; k <= d1 - d0; ++k) {
    // staged index of row s is s - (w0 - d_start - D) = 2 l + q: region q & 1, slot l + q / 2
    const int q = D + 1 - d0 - k;
    const float* r = rows + ((q & 1) * half + l + (q >> 1)) * pitch;
    const int d = d0 + k;
    float v0, v1;
    dot2<CP>(a0, a1, r, v0, v1);
    if (d < d1 && second) store(o + (size_t)d * plane + G, w + 1 >= d_start + d ? v1 * inv_c : 0.f);
    if (k > 0) store(o + (size_t)(d - 1) * plane, w >= d_start + d - 1 ? v0 * inv_c : 0.f);
  }
}

template <typename T, int CP>
cudaError_t launch_correlation(const void* fl, const void* fr, void* out, int B, int H, int W,
                               int C, int D, int d_start, int G, cudaStream_t stream) {
  const size_t smem = (size_t)((kCorrW + D + 2) / 2 * 2 + kCorrW) * (CP + 2) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        correlation_kernel<T, CP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((W + kCorrW - 1) / kCorrW, (unsigned)((size_t)B * H), (unsigned)G);
  correlation_kernel<T, CP><<<grid, kCorrThreads, smem, stream>>>(
      static_cast<const T*>(fl), static_cast<const T*>(fr), static_cast<T*>(out), H, W, C, D, d_start, G);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_correlation(const void* fl, const void* fr, void* out, int B, int H, int W,
                                 int C, int D, int d_start, int G, cudaStream_t stream) {
  const int Cg = C / G;
  if (Cg <= 8) return launch_correlation<T, 8>(fl, fr, out, B, H, W, C, D, d_start, G, stream);
  if (Cg <= 16) return launch_correlation<T, 16>(fl, fr, out, B, H, W, C, D, d_start, G, stream);
  if (Cg <= 32) return launch_correlation<T, 32>(fl, fr, out, B, H, W, C, D, d_start, G, stream);
  if (Cg <= 64) return launch_correlation<T, 64>(fl, fr, out, B, H, W, C, D, d_start, G, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Correlation volume. dtype: 0 = float32, 1 = bfloat16, 2 = float16 (fl, fr
// and out). out is [B, D, H, W, G], plane i at disparity d_start + i
// (d_start >= 0), group g the mean over channels g * C / G .. (g + 1) * C / G - 1.
// G >= 1 divides C, C / G <= 64 (else cudaErrorInvalidValue); needs
// (128 + D + 2) * (CP + 2) * 4 bytes of shared memory, CP the power of 2 from
// 8 to 64 at or above C / G (at most 227 KB).
extern "C" int ecm_cost_volume_correlation(int dtype, const void* fl, const void* fr, void* out,
                                           int B, int H, int W, int C, int D, int d_start, int G,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d_start < 0 || G < 1 || C % G) return cudaErrorInvalidValue;
  if (dtype == 1) return dispatch_correlation<__nv_bfloat16>(fl, fr, out, B, H, W, C, D, d_start, G, s);
  if (dtype == 2) return dispatch_correlation<__half>(fl, fr, out, B, H, W, C, D, d_start, G, s);
  return dispatch_correlation<float>(fl, fr, out, B, H, W, C, D, d_start, G, s);
}

// row_bytes = C * element size; plane i at disparity d_start + i
// (d_start >= 0). All pointers must be 16-byte aligned.
extern "C" int ecm_cost_volume_concat(const void* fl, const void* fr, void* out,
                                      int B, int H, int W, int row_bytes, int D,
                                      int d_start, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d_start < 0) return cudaErrorInvalidValue;
  if (row_bytes % 16 == 0) return launch<uint4>(fl, fr, out, B, H, W, row_bytes, D, d_start, s);
  if (row_bytes % 8 == 0) return launch<uint2>(fl, fr, out, B, H, W, row_bytes, D, d_start, s);
  if (row_bytes % 4 == 0) return launch<uint32_t>(fl, fr, out, B, H, W, row_bytes, D, d_start, s);
  if (row_bytes % 2 == 0) return launch<uint16_t>(fl, fr, out, B, H, W, row_bytes, D, d_start, s);
  return launch<uint8_t>(fl, fr, out, B, H, W, row_bytes, D, d_start, s);
}
