// Tensor-core implicit GEMM for the port's 3x3x3 convolutions on bf16 NDHWC
// tensors with Cin a multiple of 8 (header only; conv3d_bn.cu and
// deconv3d_bn.cu instantiate it).
//
// Modes: 1 and 2 are a convolution with zero padding 1 and that stride;
// kTransposed is ConvTranspose3d (kernel 3, stride 2, padding 1, output
// padding 1), where output o takes input i through tap k when o = 2i - 1 + k:
// per dim an even output o = 2m has the one tap (k=1, i=m) and an odd one
// o = 2m+1 the taps (k=2, i=m) and (k=0, i=m+1) when m+1 is inside.
//
// GEMM: M = 64 output voxels along W of one (b, od, oh) row (for the
// transposed conv, of one W parity: ow = 2m + pw), N = 32 or 64 output
// channels, K = the block's taps x Cin in stages of 32 channels. WMMA
// (mma.sync, bf16 in, f32 accumulate); four warps own 16 voxel rows each.
// Each stage stages the A tile (64 input rows of one tap, zero in the
// padding) and the B tile (that tap's weights, bf16 [Cin_pad][Cout_pad]) in
// shared memory; the next stage's global loads are issued into registers
// before the current stage's products, so their latency hides behind them.
// The f32 accumulators go through shared memory to ecm::epilogue, which
// writes 16-byte rows.

#pragma once

#include <mma.h>

#include "common.cuh"

namespace ecm {
namespace mma {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kTransposed = 0;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 16 * kWarps;  // output voxels per block, along W
constexpr int kKC = 32;           // input channels per stage
constexpr int kLDA = kKC + 8;     // shared-memory row pitches (elements), padded
constexpr int kLDB = 64 + 8;
constexpr int kLDC = 64 + 4;

struct Params {
  const bf16* x;       // [B, D, H, W, Cin]
  const bf16* w;       // [27][Cin_pad][Cout_pad], zero in the pads
  const float* scale;  // [Cout], or null (a scale of 1, folded into w)
  const float* bias;   // [Cout]
  const bf16* add;     // [B, add_d, Ho, Wo, Cout] with add_d in {1, Do}, or null
  bf16* out;           // [B, Do, Ho, Wo, Cout]
  int B, D, H, W, Cin, Cin_pad, Do, Ho, Wo, Cout, Cout_pad, add_d, relu;
  int nwt;             // W tiles of kBM voxels per output row (per parity if transposed)
};

// The input of one tap for the block's 64 rows: plane id, row ih, and the
// column of row r, iw0 + r * step.
struct Tap {
  int k, id, ih, iw0, step;
};

// The block's output row and the origin of its W tile.
struct Block {
  int b, od, oh, pw, m0;
};

// Number of taps of the block, and its t-th tap.
template <int MODE>
__device__ __forceinline__ int tap_count(const Params& P, const Block& k) {
  if constexpr (MODE == kTransposed) {
    const int nd = (k.od & 1) && (k.od >> 1) + 1 < P.D ? 2 : 1;
    const int nh = (k.oh & 1) && (k.oh >> 1) + 1 < P.H ? 2 : 1;
    return nd * nh * (k.pw ? 2 : 1);
  }
  return 27;
}

template <int MODE>
__device__ __forceinline__ Tap tap_at(const Params& P, const Block& k, int t) {
  if constexpr (MODE == kTransposed) {
    // per dim, entry a of output o = 2m + p: (k, i) = (1, m) if p == 0, else
    // (2, m) for a = 0 and (0, m + 1) for a = 1
    const int nw = k.pw ? 2 : 1;
    const int nh = (k.oh & 1) && (k.oh >> 1) + 1 < P.H ? 2 : 1;
    const int a = t / (nh * nw), e = (t / nw) % nh, f = t % nw;
    const int kd = (k.od & 1) ? (a ? 0 : 2) : 1;
    const int kh = (k.oh & 1) ? (e ? 0 : 2) : 1;
    const int kw = k.pw ? (f ? 0 : 2) : 1;
    return Tap{(kd * 3 + kh) * 3 + kw, (k.od >> 1) + a, (k.oh >> 1) + e, k.m0 + f, 1};
  } else {
    const int kd = t / 9, kh = (t / 3) % 3, kw = t % 3;
    return Tap{t, k.od * MODE + kd - 1, k.oh * MODE + kh - 1, k.m0 * MODE + kw - 1, MODE};
  }
}

// The output column of row r of the block, and whether it exists.
template <int MODE>
__device__ __forceinline__ int out_col(const Params& P, const Block& k, int r, bool& ok) {
  if constexpr (MODE == kTransposed) {
    ok = k.m0 + r < P.W;
    return 2 * (k.m0 + r) + k.pw;
  } else {
    ok = k.m0 + r < P.Wo;
    return k.m0 + r;
  }
}

// The 16-byte chunks one thread moves per stage: A is kBM rows x kKC/8
// chunks, B is kKC rows x NB/8 chunks.
template <int NB>
struct Stage {
  static constexpr int kA = kBM * kKC / 8 / kThreads;
  static constexpr int kB = kKC * NB / 8 / kThreads;
  uint4 a[kA];
  uint4 b[kB];
};

template <int MODE, int NB>
__device__ __forceinline__ void load_stage(Stage<NB>& st, const Params& P, const Block& k, int s,
                                           int nch, int nb0) {
  const Tap tp = tap_at<MODE>(P, k, s / nch);
  const int ci0 = (s % nch) * kKC;
  const bool row_ok = tp.id >= 0 && tp.id < P.D && tp.ih >= 0 && tp.ih < P.H;
  const bf16* row =
      row_ok ? P.x + (((size_t)k.b * P.D + tp.id) * P.H + tp.ih) * P.W * P.Cin : P.x;
#pragma unroll
  for (int e = 0; e < Stage<NB>::kA; ++e) {
    const int idx = threadIdx.x + e * kThreads;
    const int r = idx / (kKC / 8), ci = ci0 + 8 * (idx % (kKC / 8));
    const int iw = tp.iw0 + r * tp.step;
    bool out_ok;
    out_col<MODE>(P, k, r, out_ok);
    const bool ok = row_ok && out_ok && iw >= 0 && iw < P.W && ci < P.Cin;
    st.a[e] = ok ? __ldg(reinterpret_cast<const uint4*>(row + (size_t)iw * P.Cin + ci))
                 : make_uint4(0, 0, 0, 0);
  }
  const bf16* wt = P.w + ((size_t)tp.k * P.Cin_pad + ci0) * P.Cout_pad + nb0;
#pragma unroll
  for (int e = 0; e < Stage<NB>::kB; ++e) {
    const int idx = threadIdx.x + e * kThreads;
    const int r = idx / (NB / 8), q = idx % (NB / 8);
    st.b[e] = __ldg(reinterpret_cast<const uint4*>(wt + (size_t)r * P.Cout_pad + 8 * q));
  }
}

template <int NB>
__device__ __forceinline__ void store_stage(const Stage<NB>& st, bf16* As, bf16* Bs) {
#pragma unroll
  for (int e = 0; e < Stage<NB>::kA; ++e) {
    const int idx = threadIdx.x + e * kThreads;
    *reinterpret_cast<uint4*>(As + (idx / (kKC / 8)) * kLDA + 8 * (idx % (kKC / 8))) = st.a[e];
  }
#pragma unroll
  for (int e = 0; e < Stage<NB>::kB; ++e) {
    const int idx = threadIdx.x + e * kThreads;
    *reinterpret_cast<uint4*>(Bs + (idx / (NB / 8)) * kLDB + 8 * (idx % (NB / 8))) = st.b[e];
  }
}

template <int MODE, int NB>
__global__ void __launch_bounds__(kThreads) conv3d_mma_kernel(const Params P) {
  constexpr int NF = NB / 16;  // accumulator fragments per warp
  __shared__ __align__(32) bf16 As[kBM * kLDA];
  __shared__ __align__(32) bf16 Bs[kKC * kLDB];
  __shared__ __align__(32) float Cs[kBM * kLDC];

  Block k;
  int t = blockIdx.x;
  k.m0 = (t % P.nwt) * kBM; t /= P.nwt;
  k.pw = 0;
  if constexpr (MODE == kTransposed) {
    k.pw = t % 2;
    t /= 2;
  }
  k.oh = t % P.Ho; t /= P.Ho;
  k.od = t % P.Do;
  k.b = t / P.Do;
  const int nb0 = blockIdx.y * NB;
  const int warp = threadIdx.x / 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int n = 0; n < NF; ++n) wmma::fill_fragment(acc[n], 0.f);

  const int nch = P.Cin_pad / kKC;
  const int stages = tap_count<MODE>(P, k) * nch;
  Stage<NB> st;
  load_stage<MODE, NB>(st, P, k, 0, nch, nb0);
  for (int s = 0; s < stages; ++s) {
    __syncthreads();  // the previous stage's products are done with As, Bs
    store_stage<NB>(st, As, Bs);
    __syncthreads();
    if (s + 1 < stages) load_stage<MODE, NB>(st, P, k, s + 1, nch, nb0);
#pragma unroll
    for (int kk = 0; kk < kKC / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, As + warp * 16 * kLDA + kk * 16, kLDA);
#pragma unroll
      for (int n = 0; n < NF; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, Bs + kk * 16 * kLDB + n * 16, kLDB);
        wmma::mma_sync(acc[n], fa, fb, acc[n]);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < NF; ++n)
    wmma::store_matrix_sync(Cs + warp * 16 * kLDC + n * 16, acc[n], kLDC, wmma::mem_row_major);
  __syncthreads();

  // epilogue: one (voxel, 8-channel group) per thread and step
  for (int idx = threadIdx.x; idx < kBM * NB / 8; idx += kThreads) {
    const int r = idx / (NB / 8), c0 = nb0 + 8 * (idx % (NB / 8));
    bool ok;
    const int ow = out_col<MODE>(P, k, r, ok);
    if (!ok || c0 >= P.Cout) continue;
    const size_t vox = (((size_t)k.b * P.Do + k.od) * P.Ho + k.oh) * P.Wo + ow;
    const bf16* ar = nullptr;
    if (P.add) {
      const int ad = P.add_d == 1 ? 0 : k.od;
      ar = P.add + ((((size_t)k.b * P.add_d + ad) * P.Ho + k.oh) * P.Wo + ow) * P.Cout + c0;
    }
    epilogue<bf16, 8>(Cs + r * kLDC + (c0 - nb0), P.scale, P.bias, c0, P.Cout, P.relu, ar,
                      P.out + vox * P.Cout + c0, P.Cout % 8 == 0);
  }
}

// Fill the derived fields of P (Cin_pad, Cout_pad, nwt) and launch. P holds
// the input and output dims, pointers, Cin, Cout, add_d and relu.
template <int MODE>
cudaError_t launch(Params P, cudaStream_t stream) {
  if (P.Cin % 8) return cudaErrorInvalidValue;
  P.Cin_pad = (P.Cin + kKC - 1) / kKC * kKC;
  const int nb = P.Cout <= 32 ? 32 : 64;
  P.Cout_pad = (P.Cout + nb - 1) / nb * nb;
  P.nwt = ((MODE == kTransposed ? P.W : P.Wo) + kBM - 1) / kBM;
  const dim3 grid(
      (unsigned)((long long)P.B * P.Do * P.Ho * P.nwt * (MODE == kTransposed ? 2 : 1)),
      P.Cout_pad / nb);
  if (nb == 32)
    conv3d_mma_kernel<MODE, 32><<<grid, kThreads, 0, stream>>>(P);
  else
    conv3d_mma_kernel<MODE, 64><<<grid, kThreads, 0, stream>>>(P);
  return cudaGetLastError();
}

}  // namespace mma
}  // namespace ecm
