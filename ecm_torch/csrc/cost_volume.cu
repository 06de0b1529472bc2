// Concat cost volume for Hopper (sm_90a).
//
// Replaces: ecm_tpu/ops/pallas_cost_volume.py, _concat_fwd_kernel (the
// pallas_call in _concat_fwd), reached through cost_volume_pallas(mode="concat").
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

#include <cstdint>
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

}  // namespace

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
