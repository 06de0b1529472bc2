// 3x3x3 convolution, stride 1 or 2, zero padding 1, with a per-channel affine,
// optional ReLU and an optional post-activation add, for Hopper (sm_90a).
//
// Replaces: ecm_tpu/ops/pallas_gband.py, gband_conv_bn_s1 (its pallas_calls,
// stride 1) and gband_down_conv_bn (stride 2). Those kernels work on the
// TPU's disparity-folded layout; this one computes their NDHWC functions
// (gband_reference / gband_down_reference through from_grouped).
//
// Computes, for x [B, D, H, W, Cin] (NDHWC, bf16 or f32):
//   out = relu?(conv(x, k) * scale + bias) [+ add]       out [B, Do, Ho, Wo, Cout]
// with Do = (D - 1) / S + 1 (likewise H, W) and add either a residual
// [B, Do, Ho, Wo, Cout] or a context map [B, 1, Ho, Wo, Cout] broadcast over D,
// in x's type. Accumulation and epilogue are f32, rounded once at the store.
//
// Bound on the H100 (computed from the main path's shapes, B=1, bf16): the
// stride-1 convs at 48x96x312 are 159.0 GFLOP (64->32) and 79.5 GFLOP
// (32->32) against at most 276 MB, so they are bound by arithmetic on any
// unit; the stride-2 conv 32->64 to 24x48x156 is 19.9 GFLOP against 115 MB,
// bound by bytes on the tensor cores (0.034 ms) but by arithmetic on the
// CUDA cores (0.30 ms at 67 TFLOP/s f32).
//
// Two kernels behind one function:
//
// - bf16 with Cin a multiple of 8, up to 64, and Cout up to 64: the implicit
//   GEMM on the tensor cores of conv_wgmma.cuh (persistent blocks, weights
//   resident in shared memory, a ring of halo planes filled by a producer
//   warp, wgmma with A from registers), tiled by the wrapper's conv_plan.
// - otherwise (f32, or an odd Cin): a direct convolution on the CUDA cores.
//   One thread computes VX neighbouring output voxels along W and a strip of
//   CO output channels in f32 registers. All threads of a block share one
//   channel strip (blockIdx.y), so each weight row is one broadcast read
//   through the read-only cache and feeds VX FMAs per channel.

#include "conv_wgmma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kVX = 4;   // output voxels along W per thread
constexpr int kCO = 16;  // output channels per thread (one strip)

struct Params {
  const void* x;      // [B, D, H, W, Cin]
  const float* w;     // [27][Cin][Cout_pad]
  const float* scale; // [Cout]
  const float* bias;  // [Cout]
  const void* add;    // [B, add_d, Ho, Wo, Cout] with add_d in {1, Do}, or null
  void* out;          // [B, Do, Ho, Wo, Cout]
  int B, D, H, W, Cin, Do, Ho, Wo, Cout, Cout_pad, add_d, relu, nwg;
  long long groups;   // B * Do * Ho * nwg voxel groups
};

template <typename T, int S>
__global__ void __launch_bounds__(kThreads) conv3d_bn_kernel(const Params P) {
  long long v = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (v >= P.groups) return;
  const int wg = v % P.nwg; v /= P.nwg;
  const int oh = v % P.Ho; v /= P.Ho;
  const int od = v % P.Do;
  const int b = v / P.Do;
  const int ow0 = wg * kVX;
  const int c0 = blockIdx.y * kCO;
  const T* x = static_cast<const T*>(P.x);
  const bool vec = P.Cin % ecm::Vec<T>::N == 0;

  float acc[kVX][kCO];
#pragma unroll
  for (int j = 0; j < kVX; ++j)
#pragma unroll
    for (int c = 0; c < kCO; ++c) acc[j][c] = 0.f;

  for (int kd = 0; kd < 3; ++kd) {
    const int id = od * S + kd - 1;
    if (id < 0 || id >= P.D) continue;
    for (int kh = 0; kh < 3; ++kh) {
      const int ih = oh * S + kh - 1;
      if (ih < 0 || ih >= P.H) continue;
      const T* row = x + (((size_t)b * P.D + id) * P.H + ih) * P.W * P.Cin;
      for (int kw = 0; kw < 3; ++kw) {
        const T* xp[kVX];
#pragma unroll
        for (int j = 0; j < kVX; ++j) {
          const int iw = (ow0 + j) * S + kw - 1;
          xp[j] = (ow0 + j < P.Wo && iw >= 0 && iw < P.W) ? row + (size_t)iw * P.Cin : nullptr;
        }
        const float* wt = P.w + (size_t)((kd * 3 + kh) * 3 + kw) * P.Cin * P.Cout_pad + c0;
        ecm::accumulate_tap<T, kVX, kCO>(acc, xp, wt, P.Cin, P.Cout_pad, vec);
      }
    }
  }

  const bool vec_out = P.Cout % ecm::Vec<T>::N == 0 && c0 + kCO <= P.Cout;
  const T* add = static_cast<const T*>(P.add);
  T* out = static_cast<T*>(P.out);
#pragma unroll
  for (int j = 0; j < kVX; ++j) {
    const int ow = ow0 + j;
    if (ow >= P.Wo) continue;
    const size_t vox = (((size_t)b * P.Do + od) * P.Ho + oh) * P.Wo + ow;
    const T* ar = nullptr;
    if (add) {
      const int ad = P.add_d == 1 ? 0 : od;
      ar = add + ((((size_t)b * P.add_d + ad) * P.Ho + oh) * P.Wo + ow) * P.Cout + c0;
    }
    ecm::epilogue<T, kCO>(acc[j], P.scale, P.bias, c0, P.Cout, P.relu, ar,
                          out + vox * P.Cout + c0, vec_out);
  }
}

template <typename T, int S>
cudaError_t launch(const Params& P, cudaStream_t stream) {
  const dim3 grid((unsigned)((P.groups + kThreads - 1) / kThreads), P.Cout_pad / kCO);
  conv3d_bn_kernel<T, S><<<grid, kThreads, 0, stream>>>(P);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, add and out); stride: 1 or 2. w is f32
// [27][Cin][Cout_pad] with Cout_pad = Cout rounded up to 16, zero in the pad;
// scale/bias are f32 [Cout]. add may be null; add_d is its D extent (1 or Do).
// All pointers are 16-byte aligned.
extern "C" int ecm_conv3d_bn(int dtype, int stride, const void* x, const void* w,
                             const void* scale, const void* bias, const void* add, void* out,
                             int B, int D, int H, int W, int Cin, int Cout, int add_d,
                             int relu, void* stream) {
  if (stride != 1 && stride != 2) return (int)cudaErrorInvalidValue;
  Params P;
  P.x = x;
  P.w = static_cast<const float*>(w);
  P.scale = static_cast<const float*>(scale);
  P.bias = static_cast<const float*>(bias);
  P.add = add;
  P.out = out;
  P.B = B; P.D = D; P.H = H; P.W = W; P.Cin = Cin; P.Cout = Cout;
  P.Do = (D - 1) / stride + 1;
  P.Ho = (H - 1) / stride + 1;
  P.Wo = (W - 1) / stride + 1;
  P.Cout_pad = (Cout + kCO - 1) / kCO * kCO;
  P.add_d = add_d;
  P.relu = relu;
  P.nwg = (P.Wo + kVX - 1) / kVX;
  P.groups = (long long)B * P.Do * P.Ho * P.nwg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return stride == 1 ? launch<__nv_bfloat16, 1>(P, s) : launch<__nv_bfloat16, 2>(P, s);
  return stride == 1 ? launch<float, 1>(P, s) : launch<float, 2>(P, s);
}

// The tensor-core kernel: x, add and out bf16 with Cin % 8 == 0, Cin <= 64,
// Cout <= 64. w is bf16 [27][Cin_pad / 16][Cout_pad / 8][2][8][8] (element
// (tap, ci, co) at ((tap * Cin_pad / 16 + ci / 16) * Cout_pad / 8 + co / 8) *
// 128 + (ci % 16) / 8 * 64 + (co % 8) * 8 + ci % 8) with Cin_pad = Cin rounded
// up to 16 and Cout_pad = 16, 32 or 64, zero in the pads; scale/bias f32
// [Cout]. add may be null; add_d is its D extent (1 or Do). sd (output
// planes per work item), ring (slots), grid (blocks) and smem (bytes) are
// the wrapper's plan; the launch fails if smem is not the plan's. All
// pointers are 16-byte aligned.
extern "C" int ecm_conv3d_bn_mma(int stride, const void* x, const void* w, const void* scale,
                                 const void* bias, const void* add, void* out, int B, int D,
                                 int H, int W, int Cin, int Cout, int add_d, int relu, int sd,
                                 int ring, int grid, long long smem, void* stream) {
  if (stride != 1 && stride != 2) return (int)cudaErrorInvalidValue;
  ecm::wg::Params P;
  P.x = static_cast<const __nv_bfloat16*>(x);
  P.w = static_cast<const __nv_bfloat16*>(w);
  P.scale = static_cast<const float*>(scale);
  P.bias = static_cast<const float*>(bias);
  P.add = static_cast<const __nv_bfloat16*>(add);
  P.out = static_cast<__nv_bfloat16*>(out);
  P.B = B; P.D = D; P.H = H; P.W = W; P.Cin = Cin; P.Cout = Cout;
  P.Do = (D - 1) / stride + 1;
  P.Ho = (H - 1) / stride + 1;
  P.Wo = (W - 1) / stride + 1;
  P.add_d = add_d;
  P.relu = relu;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return stride == 1 ? ecm::wg::launch<1>(P, sd, ring, grid, smem, s)
                     : ecm::wg::launch<2>(P, sd, ring, grid, smem, s);
}
