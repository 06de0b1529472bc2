// ConvTranspose3d (kernel 3, stride 2, padding 1, output padding 1: every
// dim doubles) with a bias, optional ReLU and an optional add, for Hopper
// (sm_90a).
//
// Replaces: ecm_tpu/ops/pallas_gdeconv.py, gdeconv4_bn (its pallas_call),
// which emits the TPU's disparity-folded layout; this kernel computes its
// NDHWC function (gdeconv4_reference through from_grouped).
//
// Computes, for x [B, D, H, W, Cin] (NDHWC, bf16 or f32) and torch's
// ConvTranspose3d weight [Cin, Cout, 3, 3, 3] with the BN scale already folded
// in (in x's type, as the TPU kernel folds it):
//   out = relu?(convT(x, w) + bias) [+ add]               out [B, 2D, 2H, 2W, Cout]
// add [B, 2D, 2H, 2W, Cout] in x's type. f32 accumulation and epilogue, one
// rounding at the store.
//
// Index rule (torch's): output o takes input i through tap k when
// o = 2i - 1 + k. Per dim an even output o = 2m has one tap (k=1, i=m); an odd
// output o = 2m+1 has two (k=2, i=m and k=0, i=m+1 when m+1 is inside). So an
// output voxel gathers 1, 2, 4 or 8 taps, 27/8 on average.
//
// Bound on the H100 (computed from the main path's shape, B=1, bf16: 64->32
// from 24x48x156 to 48x96x312 with the residual): 19.9 GFLOP against 207 MB,
// bound by bytes (0.062 ms).
//
// Two kernels behind one function:
//
// - bf16 with Cin a multiple of 8, up to 64, and Cout up to 64: the implicit
//   GEMM on the tensor cores of conv_wgmma.cuh in its transposed mode (a
//   block takes an input tile with a halo of one and writes all eight parity
//   classes of its outputs, each over that class's legal taps only).
// - otherwise (f32, or an odd Cin): a gather on the CUDA cores. One thread
//   computes VX output voxels of one W parity (ow = 2m + pw for VX
//   consecutive m), which share their tap pattern, and a strip of CO output
//   channels in f32 registers; all threads of a block share the strip, so
//   each weight row is a broadcast read feeding VX FMAs per channel.

#include "conv_wgmma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kVX = 4;   // output voxels of one W parity per thread
constexpr int kCO = 16;  // output channels per thread (one strip)

struct Params {
  const void* x;      // [B, D, H, W, Cin]
  const float* w;     // [27][Cin][Cout_pad]
  const float* bias;  // [Cout]
  const void* add;    // [B, 2D, 2H, 2W, Cout] or null
  void* out;          // [B, 2D, 2H, 2W, Cout]
  int B, D, H, W, Cin, Cout, Cout_pad, relu, nmg;
  long long groups;   // B * 2D * 2H * 2 * nmg voxel groups
};

// Taps of output index o along a dim of n inputs: count, kernel index k[],
// input index i[].
__device__ __forceinline__ int phase_taps(int o, int n, int (&k)[2], int (&i)[2]) {
  const int m = o >> 1;
  if ((o & 1) == 0) {
    k[0] = 1; i[0] = m;
    return 1;
  }
  k[0] = 2; i[0] = m;
  if (m + 1 < n) {
    k[1] = 0; i[1] = m + 1;
    return 2;
  }
  return 1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) deconv3d_bn_kernel(const Params P) {
  long long v = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (v >= P.groups) return;
  const int mg = v % P.nmg; v /= P.nmg;
  const int pw = v % 2; v /= 2;
  const int oh = v % (2 * P.H); v /= 2 * P.H;
  const int od = v % (2 * P.D);
  const int b = v / (2 * P.D);
  const int m0 = mg * kVX;
  const int c0 = blockIdx.y * kCO;
  const T* x = static_cast<const T*>(P.x);
  const bool vec = P.Cin % ecm::Vec<T>::N == 0;

  int kd[2], id[2], kh[2], ih[2];
  const int nd = phase_taps(od, P.D, kd, id);
  const int nh = phase_taps(oh, P.H, kh, ih);
  // along W: even outputs take k=1 at i=m; odd ones k=2 at i=m and k=0 at i=m+1
  const int nw = pw == 0 ? 1 : 2;
  const int kw[2] = {pw == 0 ? 1 : 2, 0};
  const int dw[2] = {0, 1};

  float acc[kVX][kCO];
#pragma unroll
  for (int j = 0; j < kVX; ++j)
#pragma unroll
    for (int c = 0; c < kCO; ++c) acc[j][c] = 0.f;

  for (int a = 0; a < nd; ++a) {
    for (int e = 0; e < nh; ++e) {
      const T* row = x + (((size_t)b * P.D + id[a]) * P.H + ih[e]) * P.W * P.Cin;
      for (int f = 0; f < nw; ++f) {
        const T* xp[kVX];
#pragma unroll
        for (int j = 0; j < kVX; ++j) {
          const int iw = m0 + j + dw[f];
          xp[j] = (m0 + j < P.W && iw < P.W) ? row + (size_t)iw * P.Cin : nullptr;
        }
        const float* wt =
            P.w + (size_t)((kd[a] * 3 + kh[e]) * 3 + kw[f]) * P.Cin * P.Cout_pad + c0;
        ecm::accumulate_tap<T, kVX, kCO>(acc, xp, wt, P.Cin, P.Cout_pad, vec);
      }
    }
  }

  const bool vec_out = P.Cout % ecm::Vec<T>::N == 0 && c0 + kCO <= P.Cout;
  const T* add = static_cast<const T*>(P.add);
  T* out = static_cast<T*>(P.out);
  const int Wo = 2 * P.W;
#pragma unroll
  for (int j = 0; j < kVX; ++j) {
    if (m0 + j >= P.W) continue;
    const size_t vox = (((size_t)b * 2 * P.D + od) * 2 * P.H + oh) * Wo + 2 * (m0 + j) + pw;
    ecm::epilogue<T, kCO>(acc[j], nullptr, P.bias, c0, P.Cout, P.relu,
                          add ? add + vox * P.Cout + c0 : nullptr, out + vox * P.Cout + c0,
                          vec_out);
  }
}

template <typename T>
cudaError_t launch(const Params& P, cudaStream_t stream) {
  const dim3 grid((unsigned)((P.groups + kThreads - 1) / kThreads), P.Cout_pad / kCO);
  deconv3d_bn_kernel<T><<<grid, kThreads, 0, stream>>>(P);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, add and out). w is f32 [27][Cin][Cout_pad]
// (tap = (kd * 3 + kh) * 3 + kw of torch's [Cin, Cout, kd, kh, kw], scale folded
// in) with Cout_pad = Cout rounded up to 16, zero in the pad; bias is f32
// [Cout]. add may be null. All pointers are 16-byte aligned.
extern "C" int ecm_deconv3d_bn(int dtype, const void* x, const void* w, const void* bias,
                               const void* add, void* out, int B, int D,
                               int H, int W, int Cin, int Cout, int relu, void* stream) {
  Params P;
  P.x = x;
  P.w = static_cast<const float*>(w);
  P.bias = static_cast<const float*>(bias);
  P.add = add;
  P.out = out;
  P.B = B; P.D = D; P.H = H; P.W = W; P.Cin = Cin; P.Cout = Cout;
  P.Cout_pad = (Cout + kCO - 1) / kCO * kCO;
  P.relu = relu;
  P.nmg = (W + kVX - 1) / kVX;
  P.groups = (long long)B * 2 * D * 2 * H * 2 * P.nmg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch<__nv_bfloat16>(P, s) : launch<float>(P, s);
}

// The tensor-core kernel: x, add and out bf16 with Cin % 8 == 0, Cin <= 64,
// Cout <= 64. w is packed as ecm_conv3d_bn_mma's (tap as above, scale folded
// in); bias is f32 [Cout]. add may be null. sd (input planes per work item),
// ring, grid and smem are the wrapper's plan. All pointers are 16-byte
// aligned.
extern "C" int ecm_deconv3d_bn_mma(const void* x, const void* w, const void* bias,
                                   const void* add, void* out, int B, int D, int H, int W,
                                   int Cin, int Cout, int relu, int sd, int ring, int grid,
                                   long long smem, void* stream) {
  ecm::wg::Params P;
  P.x = static_cast<const __nv_bfloat16*>(x);
  P.w = static_cast<const __nv_bfloat16*>(w);
  P.scale = nullptr;
  P.bias = static_cast<const float*>(bias);
  P.add = static_cast<const __nv_bfloat16*>(add);
  P.out = static_cast<__nv_bfloat16*>(out);
  P.B = B; P.D = D; P.H = H; P.W = W; P.Cin = Cin; P.Cout = Cout;
  P.Do = 2 * D;
  P.Ho = 2 * H;
  P.Wo = 2 * W;
  P.add_d = 2 * D;
  P.relu = relu;
  return ecm::wg::launch<ecm::wg::kTransposed>(P, sd, ring, grid, smem,
                                               static_cast<cudaStream_t>(stream));
}
