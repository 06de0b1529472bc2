// Two fused 3x3x3 stride-1 convolutions for Hopper (sm_90a).
//
// Replaces: ecm_tpu/ops/pallas_fused_agg.py, fused_conv3d_pair (its
// pallas_call in _fused_conv3d_pair_pallas), and the NDHWC function of
// ecm_tpu/ops/pallas_gband.py, gband_classif_head (the classif form).
//
// Computes, for x [B, D, H, W, Cin] (NDHWC, bf16 or f32):
//   y   = E1(conv(x, k1))             rounded to the input type
//   out = E2(conv(y, k2)) [+ ctx] [+ x[..., :Cout]]
// with Ei(v) = relu?(v * scale_i + bias_i) in f32, both convs zero-padded by
// one voxel, ctx [B, H, W, Cout] broadcast over D. y is ZERO at every position
// outside the volume (stage 2 zero-pads y: the halo must not hold stage 1
// evaluated on padding), and y never leaves the SM. Accumulation is f32.
//
// Bound on the H100: operations. At the main-path shape (B=1, 48x96x312,
// 1,437,696 voxels) dres0 (64->32->32) is 238.5 GFLOP, dres1 (32->32->32)
// 159.0 GFLOP and the classifier (32->32->1) 82.0 GFLOP: 0.241 / 0.161 /
// 0.083 ms at 989 TFLOP/s dense bf16, against 276 MB or less of traffic
// (0.082 ms at 3.35 TB/s). Stage 1 is most of the work (79.5 of the
// classifier's 82.0 GFLOP), and it is recomputed over the tile's halo.
//
// Two routes, chosen by the wrapper (ops/cuda_fused_agg.py, pair_route):
//
// 1. fused_pair_wgmma_kernel, the tensor cores: bf16, Cin % 8 == 0, Cm == 32,
//    Cout == 1 or a multiple of 8 up to 32 (every form a path of the port
//    launches). Built from the parts of the conv core (conv_wgmma.cuh, PTX in
//    wgmma.cuh):
//    - Both stages are wgmma.mma_async m64nNk16 with both operands read from
//      shared memory through descriptors: stage 1 N = 32 (y's channels), K =
//      27 x Cin; stage 2 N = Cout padded to 8, 16 or 32 (the classifier's
//      8 is wgmma's smallest N), K = 27 x 32. M = 64 consecutive positions
//      along W.
//    - The halo against M = 64: a tile is TH output rows (H) of 62 columns
//      (W). Stage 1 computes TH + 2 y rows of 64 columns (w0 - 1 .. w0 + 62)
//      from TH + 4 x rows of 66 (w0 - 2 .. w0 + 63); stage 2 computes 64
//      output columns and stores the first 62 (the last two read y columns
//      that stage 1 did not compute; a wgmma row depends on its own A row
//      only). 312 = 5 x 62 + 2, so the last W tile of the main paths is
//      ragged. The wrapper's plan reports the waste as `recompute`: stage-1
//      positions computed per output voxel.
//    - Shared slots are channel-chunk major, [C / 8][rows][8] bf16 at a row
//      pitch of 66 for x and y, so that any 8 consecutive rows of a chunk are
//      one of wgmma's 128-byte core matrices, and a tap (kh, kw) is the
//      offset (row + kh) * 66 + kw of the A descriptor's start, never a load.
//    - A work item is an (H, W) tile and a slab of SD output planes along D.
//      The block walks the item's y planes d0 - 1 .. d0 + SD in order: a step
//      computes one y plane into a ring of three y slots, then (from the
//      third) the output plane before it from the three y slots. Stage 1's
//      epilogue (scale, bias, ReLU, zero outside the volume, bf16) stores
//      from the accumulator registers into the y slot in stage 2's layout:
//      y never leaves the SM.
//    - x streams through a ring of stages, one per (y plane, kd, 16 input
//      channels): the x plane under that tap plane, two TMA boxes of 8
//      channels x 66 columns x TH + 4 rows from a tensor map of x, zero
//      outside the volume and past Cin. k2 is resident in shared memory for
//      the whole kernel; k1 too where it fits beside the rings (Cin <= 32 at
//      the main shapes), else each stage carries that kd's 9 taps of k1 for
//      its 16 channels (9,216 B, nine TMA bulk copies).
//    - Warp specialisation and persistence, as in the conv core: one
//      persistent block per SM over the work items; one thread of a producer
//      warp issues each stage's TMA loads onto the slot's `full` mbarrier
//      (a transaction count); two consumer warpgroups each own every other y
//      row and output row, issue a stage's products as one group and hand
//      the previous stage's slot back (`empty`) when this one is issued, so
//      the loads run under the products. The consumers meet at a named
//      barrier before a y slot is overwritten and after it is written. Every
//      branch around a wgmma is warp-uniform in a way ptxas can see (roles
//      from a shuffled warp index, item and plane bounds, barrier waits
//      inside one asm statement); otherwise it serialises them (C7520).
//    - The epilogues keep their scales and biases in registers; stage 2's ctx
//      and residual values are loaded while its products run.
//    - Tiles (the plan, cuda_fused_agg.pair_plan, picks the first that fits
//      232,448 B with a ring of two): TH = 4 with k1 resident (N2 = 8 only:
//      ptxas gives a thread of this block 168 registers, and TH = 4 spills
//      at N2 = 16), then TH = 2 with k1 resident, then TH = 2 with k1
//      streamed; the ring as long as fits, up to 8. The classifier runs TH
//      = 4 (229,760 B, ring 5), dres1 TH = 2 (225,408 B, ring 5), dres0 TH =
//      2 streamed (216,192 B, ring 5).
//
// 2. fused_pair_kernel, the CUDA cores: f32, or channel counts outside those
//    (no path of the port launches it). One block per 4x8x16 output tile;
//    stage 1 computes y over the tile and its halo into shared memory, one
//    thread per position and 32 channels in registers, f32 FMA, weights f32
//    through the read-only cache; stage 2 one thread per output voxel and
//    group of CO2 channels (32, or 1 for the classifier).

#include "common.cuh"

namespace {

using ecm::from_f32;
using ecm::to_f32;
using ecm::Vec;

constexpr int kThreads = 256;
constexpr int kCm = 32;  // stage-1 output channels held in registers per pass

struct Params {
  const void* x;
  const float* k1;  // [27][Cin][Cm_pad]
  const float* s1;
  const float* b1;
  const float* k2;  // [27][Cm][Cout_pad]
  const float* s2;
  const float* b2;
  const void* ctx;  // [B, H, W, Cout] or null
  void* out;        // [B, D, H, W, Cout]
  int B, D, H, W, Cin, Cm, Cm_pad, Cout, Cout_pad;
  int relu1, relu2, residual;
  int td, th, tw, nd, nh, nw;
};

template <typename T, int CO2>
__global__ void __launch_bounds__(kThreads, 2) fused_pair_kernel(const Params P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* y1 = reinterpret_cast<T*>(smem_raw);  // [Cm][P1]
  const T* x = static_cast<const T*>(P.x);

  int blk = blockIdx.x;
  const int tw_i = blk % P.nw; blk /= P.nw;
  const int th_i = blk % P.nh; blk /= P.nh;
  const int td_i = blk % P.nd;
  const int b = blk / P.nd;
  const int d0 = td_i * P.td, h0 = th_i * P.th, w0 = tw_i * P.tw;
  const int ed = P.td + 2, eh = P.th + 2, ew = P.tw + 2;
  const int P1 = ed * eh * ew;
  const bool vec_ok = P.Cin % Vec<T>::N == 0;

  // ---- stage 1: y over the tile and its halo, zero outside the volume ----
  for (int p = threadIdx.x; p < P1; p += kThreads) {
    const int lw = p % ew, lh = (p / ew) % eh, ld = p / (ew * eh);
    const int ad = d0 - 1 + ld, ah = h0 - 1 + lh, aw = w0 - 1 + lw;
    const bool inside = ad >= 0 && ad < P.D && ah >= 0 && ah < P.H && aw >= 0 && aw < P.W;
    for (int c0 = 0; c0 < P.Cm; c0 += kCm) {
      float acc[kCm];
#pragma unroll
      for (int j = 0; j < kCm; ++j) acc[j] = 0.f;
      if (inside) {
        for (int kd = 0; kd < 3; ++kd) {
          const int id = ad + kd - 1;
          if (id < 0 || id >= P.D) continue;
          for (int kh = 0; kh < 3; ++kh) {
            const int ih = ah + kh - 1;
            if (ih < 0 || ih >= P.H) continue;
            for (int kw = 0; kw < 3; ++kw) {
              const int iw = aw + kw - 1;
              if (iw < 0 || iw >= P.W) continue;
              const T* xp = x + ((((size_t)b * P.D + id) * P.H + ih) * P.W + iw) * P.Cin;
              const float* wp = P.k1 + (size_t)((kd * 3 + kh) * 3 + kw) * P.Cin * P.Cm_pad + c0;
              if (vec_ok) {
                for (int ci = 0; ci < P.Cin; ci += Vec<T>::N) {
                  float xv[Vec<T>::N];
                  Vec<T>::load(xp + ci, xv);
#pragma unroll
                  for (int j = 0; j < Vec<T>::N; ++j)
                    ecm::fma_strip<kCm>(acc, xv[j], wp + (size_t)(ci + j) * P.Cm_pad);
                }
              } else {
                for (int ci = 0; ci < P.Cin; ++ci)
                  ecm::fma_strip<kCm>(acc, to_f32(xp[ci]), wp + (size_t)ci * P.Cm_pad);
              }
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kCm; ++j) {
        const int c = c0 + j;
        if (c < P.Cm) {
          float v = 0.f;
          if (inside) {
            v = acc[j] * __ldg(P.s1 + c) + __ldg(P.b1 + c);
            if (P.relu1) v = fmaxf(v, 0.f);
          }
          y1[(size_t)c * P1 + p] = from_f32<T>(v);
        }
      }
    }
  }
  __syncthreads();

  // ---- stage 2: out over the tile from shared memory, then the epilogue ----
  const int P2 = P.td * P.th * P.tw;
  const int groups = P.Cout_pad / CO2;
  const T* ctx = static_cast<const T*>(P.ctx);
  T* out = static_cast<T*>(P.out);
  for (int task = threadIdx.x; task < P2 * groups; task += kThreads) {
    const int q = task % P2, g = task / P2;
    const int lw = q % P.tw, lh = (q / P.tw) % P.th, ld = q / (P.tw * P.th);
    const int ad = d0 + ld, ah = h0 + lh, aw = w0 + lw;
    if (ad >= P.D || ah >= P.H || aw >= P.W) continue;
    float acc[CO2];
#pragma unroll
    for (int j = 0; j < CO2; ++j) acc[j] = 0.f;
    for (int kd = 0; kd < 3; ++kd)
      for (int kh = 0; kh < 3; ++kh)
        for (int kw = 0; kw < 3; ++kw) {
          const int pos = ((ld + kd) * eh + (lh + kh)) * ew + (lw + kw);
          const float* wp =
              P.k2 + (size_t)((kd * 3 + kh) * 3 + kw) * P.Cm * P.Cout_pad + g * CO2;
          for (int cm = 0; cm < P.Cm; ++cm) {
            const float yv = to_f32(y1[(size_t)cm * P1 + pos]);
            if constexpr (CO2 == 32) {
              ecm::fma_strip<32>(acc, yv, wp + (size_t)cm * P.Cout_pad);
            } else {
#pragma unroll
              for (int j = 0; j < CO2; ++j)
                acc[j] += yv * __ldg(wp + (size_t)cm * P.Cout_pad + j);
            }
          }
        }
    const size_t vox = (((size_t)b * P.D + ad) * P.H + ah) * P.W + aw;
#pragma unroll
    for (int j = 0; j < CO2; ++j) {
      const int co = g * CO2 + j;
      if (co < P.Cout) {
        float v = acc[j] * __ldg(P.s2 + co) + __ldg(P.b2 + co);
        if (P.relu2) v = fmaxf(v, 0.f);
        if (ctx) v += to_f32(ctx[(((size_t)b * P.H + ah) * P.W + aw) * P.Cout + co]);
        if (P.residual) v += to_f32(x[vox * P.Cin + co]);
        out[vox * P.Cout + co] = from_f32<T>(v);
      }
    }
  }
}

template <typename T, int CO2>
cudaError_t launch(const Params& P, cudaStream_t stream) {
  const size_t smem =
      (size_t)P.Cm * (P.td + 2) * (P.th + 2) * (P.tw + 2) * sizeof(T);
  auto kernel = fused_pair_kernel<T, CO2>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)P.B * P.nd * P.nh * P.nw;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(P);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, ctx and out). k1 is f32
// [27][Cin][Cm_pad] with Cm_pad = Cm rounded up to 32; k2 is f32
// [27][Cm][Cout_pad] with Cout_pad = 1 if Cout == 1 else Cout rounded up to
// 32; pads are zero. scale/bias are f32. ctx may be null. All pointers are
// 16-byte aligned. (td, th, tw) is the output tile.
extern "C" int ecm_fused_conv3d_pair(
    int dtype, const void* x, const void* k1, const void* s1, const void* b1,
    const void* k2, const void* s2, const void* b2, const void* ctx, void* out,
    int B, int D, int H, int W, int Cin, int Cm, int Cout, int relu1, int relu2,
    int residual, int td, int th, int tw, void* stream) {
  Params P;
  P.x = x;
  P.k1 = static_cast<const float*>(k1);
  P.s1 = static_cast<const float*>(s1);
  P.b1 = static_cast<const float*>(b1);
  P.k2 = static_cast<const float*>(k2);
  P.s2 = static_cast<const float*>(s2);
  P.b2 = static_cast<const float*>(b2);
  P.ctx = ctx;
  P.out = out;
  P.B = B; P.D = D; P.H = H; P.W = W;
  P.Cin = Cin; P.Cm = Cm; P.Cout = Cout;
  P.Cm_pad = (Cm + kCm - 1) / kCm * kCm;
  P.Cout_pad = Cout == 1 ? 1 : (Cout + 31) / 32 * 32;
  P.relu1 = relu1; P.relu2 = relu2; P.residual = residual;
  P.td = td; P.th = th; P.tw = tw;
  P.nd = (D + td - 1) / td;
  P.nh = (H + th - 1) / th;
  P.nw = (W + tw - 1) / tw;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (Cout == 1) return launch<__nv_bfloat16, 1>(P, s);
    return launch<__nv_bfloat16, 32>(P, s);
  }
  if (Cout == 1) return launch<float, 1>(P, s);
  return launch<float, 32>(P, s);
}

// ---- route 1: the tensor cores ----

#include <cuda.h>  // CUtensorMap and its enums (the encoder is reached through the runtime)

#include "wgmma.cuh"

namespace {
namespace pair_wg {

using bf16 = __nv_bfloat16;
namespace ptx = ecm::ptx;

constexpr int kM = 64;          // y columns of a row: one wgmma's M
constexpr int kTW = kM - 2;     // output columns of a tile
constexpr int kPitch = kM + 2;  // x columns of a stage, and the row pitch of x and y slots
constexpr int kCm = 32;         // stage-1 channels: N of stage 1, K per tap of stage 2
constexpr int kKC = 16;         // input channels of a ring stage: one k-step
constexpr int kNWG = 2;         // consumer warpgroups
constexpr int kThreads = 128 * kNWG + 32;  // and one producer warp
constexpr int kMaxRing = 8;
constexpr int kYSlots = 3;
constexpr int kBarBytes = 128;          // full[kMaxRing], empty[kMaxRing] ahead of the weights
constexpr int kTapBytes = kCm * 16 * 2;  // k1's B operand for one (tap, 16 input channels)
constexpr int kW1Stage = 9 * kTapBytes;  // a streamed stage's k1: 9 taps x 16 channels
constexpr long long kSmemMax = 232448;

// the x rows of a stage's 8-channel chunk, rounded up to 8 rows (128 bytes)
__host__ __device__ constexpr int x_chunk_rows(int th) { return ((th + 4) * kPitch + 7) / 8 * 8; }

template <int TH>
struct Tile {
  static constexpr int kYR = TH + 2, kXR = TH + 4;  // y rows, x rows
  static constexpr int kYRows = kYR * kPitch, kXRows = kXR * kPitch;
  static constexpr int kXChunk = x_chunk_rows(TH);  // rows from one 8-channel chunk to the next
  static constexpr int kYBytes = kCm / 8 * kYRows * 16;
  static constexpr int kXBytes = kKC / 8 * kXChunk * 16;
  static constexpr int kYPW = kYR / kNWG, kOPW = TH / kNWG;  // y rows, output rows of a warpgroup
};

__host__ __device__ constexpr long long smem_bytes(int th, int ks1, int n2, int resident, int ring) {
  return kBarBytes + (resident ? 27LL * ks1 * kTapBytes : 0) + 27LL * kCm * n2 * 2 +
         (long long)kYSlots * (kCm / 8) * (th + 2) * kPitch * 16 +
         (long long)ring * ((kKC / 8) * x_chunk_rows(th) * 16 + (resident ? 0 : kW1Stage));
}

struct Params {
  const bf16* x;         // [B, D, H, W, Cin]
  const bf16* k1;        // [27][ks1][Cm / 8][2][8][8]: cuda_gband.pack_conv_wgmma
  const float* s1;       // [Cm]
  const float* b1;
  const bf16* k2;        // [27][Cm / 16][N2 / 8][2][8][8]
  const float* s2;       // [Cout]
  const float* b2;
  const bf16* ctx;       // [B, H, W, Cout] or null
  bf16* out;             // [B, D, H, W, Cout]
  int B, D, H, W, Cin, Cout, ks1;  // ks1: Cin rounded up to 16, / 16: the stages of a tap plane
  int relu1, relu2, residual, resident;
  int sd, nsd, nth, ntw, ring;
  long long items;
};

struct Item {
  int b, d0, nd, h0, w0;  // tile origin, output planes [d0, d0 + nd)
};

template <int TH>
__device__ __forceinline__ Item item_at(const Params& P, long long i) {
  Item it;
  it.w0 = (int)(i % P.ntw) * kTW;
  i /= P.ntw;
  it.h0 = (int)(i % P.nth) * TH;
  i /= P.nth;
  it.d0 = (int)(i % P.nsd) * P.sd;
  it.b = (int)(i / P.nsd);
  it.nd = min(P.sd, P.D - it.d0);
  return it;
}

// the tap planes kd in [kd0, kd1) of y plane dy whose x plane dy - 1 + kd
// lies inside the volume (none when dy itself lies outside)
__device__ __forceinline__ int kd_lo(int dy) { return dy >= 1 ? 0 : 1; }
__device__ __forceinline__ int kd_hi(const Params& P, int dy) {
  return dy < 0 || dy >= P.D ? 0 : min(3, P.D + 1 - dy);
}

template <int N>
__device__ __forceinline__ void retire(float (&d)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) ptx::fence_operand(d[i]);
}

template <int TH, int N2>
__global__ void __launch_bounds__(kThreads, 1)
    fused_pair_wgmma_kernel(const Params P, const __grid_constant__ CUtensorMap xmap) {
  using T = Tile<TH>;
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxRing;
  unsigned char* k1s = smem + kBarBytes;  // resident k1, or nothing
  const int k1bytes = P.resident ? 27 * P.ks1 * kTapBytes : 0;
  unsigned char* k2s = k1s + k1bytes;
  constexpr int k2bytes = 27 * kCm * N2 * 2;
  unsigned char* ys = k2s + k2bytes;  // [kYSlots][Cm / 8][kYRows][16 B]
  unsigned char* ring = ys + kYSlots * T::kYBytes;
  const int stage_bytes = T::kXBytes + (P.resident ? 0 : kW1Stage);
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);  // uniform, and seen so

  if (tid == 0) {
    for (int i = 0; i < P.ring; ++i) {
      ptx::mbar_init(full + i, 1);
      ptx::mbar_init(empty + i, 128 * kNWG);
    }
    ptx::mbar_init_fence();
  }
  {
    const unsigned char* w1 = reinterpret_cast<const unsigned char*>(P.k1);
    const unsigned char* w2 = reinterpret_cast<const unsigned char*>(P.k2);
    for (int i = tid; i < k1bytes / 16; i += kThreads) ptx::cp_async16(k1s + 16 * i, w1 + 16 * i, true);
    for (int i = tid; i < k2bytes / 16; i += kThreads) ptx::cp_async16(k2s + 16 * i, w2 + 16 * i, true);
  }
  ptx::cp_async_commit();
  ptx::cp_async_wait<0>();
  ptx::fence_proxy_async();
  __syncthreads();

  if (warp == 4 * kNWG) {  // the producer warp: one thread issues the stages' TMA loads
    if (lane != 0) return;
    int slot = 0, wrapped = 0;  // the next stage's slot; its parity of use, and whether used
    for (long long i = blockIdx.x; i < P.items; i += gridDim.x) {
      const Item it = item_at<TH>(P, i);
      for (int j = 0; j < it.nd + 2; ++j) {
        const int dy = it.d0 - 1 + j;
        for (int kd = kd_lo(dy); kd < kd_hi(P, dy); ++kd)
          for (int c = 0; c < P.ks1; ++c) {
            if (wrapped) ptx::mbar_wait(empty + slot, (wrapped - 1) & 1);
            unsigned char* dst = ring + slot * stage_bytes;
            // x plane dy - 1 + kd under the tile and its halo, 8 channels a
            // box, zero outside the volume and past Cin; a streamed k1 after
            // it: kd's 9 taps for these channels, [9][Cm / 8][2][8][8]
            ptx::mbar_expect_tx(full + slot, T::kXRows * kKC * 2 + (P.resident ? 0 : kW1Stage));
            for (int q = 0; q < kKC / 8; ++q)
              ptx::tma_load_5d(dst + q * T::kXChunk * 16, &xmap, kKC * c + 8 * q, it.w0 - 2, it.h0 - 2,
                               dy - 1 + kd, it.b, full + slot);
            if (!P.resident)
              for (int tap = 0; tap < 9; ++tap)
                ptx::bulk_load(dst + T::kXBytes + tap * kTapBytes,
                               reinterpret_cast<const unsigned char*>(P.k1) +
                                   (size_t)((kd * 9 + tap) * P.ks1 + c) * kTapBytes,
                               kTapBytes, full + slot);
            if (++slot == P.ring) {
              slot = 0;
              ++wrapped;
            }
          }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns y rows wg + kNWG r and output rows wg + kNWG
  // r; warp (warp % 4) holds the accumulator rows (tile columns) 16 (warp %
  // 4) + g and + 8, channels 8 j + 2 t4 (+ 1)
  const int wg = warp / 4, g = lane >> 2, t4 = lane & 3;
  const int col = 16 * (warp % 4) + g;
  const uint64_t k1desc = ptx::wgmma_desc(k1s, 128, 256);
  const uint64_t k2desc = ptx::wgmma_desc(k2s, 128, 256);
  const int tstride = P.resident ? P.ks1 : 1;  // k1 k-steps from one tap to the next
  // this thread's channels of both affines, in registers
  float sc1[kCm / 4], bi1[kCm / 4], sc2[N2 / 4], bi2[N2 / 4];
#pragma unroll
  for (int e = 0; e < kCm / 4; ++e) {
    const int ch = 8 * (e / 2) + 2 * t4 + e % 2;
    sc1[e] = P.s1[ch];
    bi1[e] = P.b1[ch];
  }
#pragma unroll
  for (int e = 0; e < N2 / 4; ++e) {
    const int ch = min(8 * (e / 2) + 2 * t4 + e % 2, P.Cout - 1);  // pad channels: never stored
    sc2[e] = P.s2[ch];
    bi2[e] = P.b2[ch];
  }
  int slot = 0, phase = 0;  // the next stage's slot and the parity of its use
  int J = 0;  // sequence number of the y plane: its slot is J % kYSlots
  for (long long i = blockIdx.x; i < P.items; i += gridDim.x) {
    const Item it = item_at<TH>(P, i);
    for (int j = 0; j < it.nd + 2; ++j, ++J) {
      const int dy = it.d0 - 1 + j;
      // ---- stage 1: y plane dy, this warpgroup's rows ----
      float acc[T::kYPW][kCm / 2];
      const int kd0 = kd_lo(dy), kd1 = kd_hi(P, dy);
      int prev = -1;  // the slot of the stage issued before, not yet handed back
      for (int kd = kd0; kd < kd1; ++kd)
        for (int c = 0; c < P.ks1; ++c) {
          ptx::mbar_wait(full + slot, phase);  // TMA wrote it: async proxy, no fence
          unsigned char* st = ring + slot * stage_bytes;
          // A: the stage's x rows (8-channel chunks kXChunk rows apart); B: k1
          const uint64_t xdesc = ptx::wgmma_desc(st, T::kXChunk * 16, 128);
          const uint64_t wdesc = P.resident ? k1desc + (uint64_t)(kd * 9 * P.ks1 + c) * (kTapBytes / 16)
                                            : ptx::wgmma_desc(st + T::kXBytes, 128, 256);
          const int first = kd == kd0 && c == 0;
          ptx::wgmma_fence();
#pragma unroll
          for (int tap = 0; tap < 9; ++tap)
#pragma unroll
            for (int r = 0; r < T::kYPW; ++r) {
              const int yr = wg + kNWG * r;
              ptx::wgmma_ss<kCm>(acc[r], xdesc + (yr + tap / 3) * kPitch + tap % 3,
                                 wdesc + (uint64_t)(tap * tstride) * (kTapBytes / 16), !first | tap);
            }
          ptx::wgmma_commit();
          // the stage before has retired: its slot goes back. The waits are
          // unconditional: a wait on a path ptxas cannot rule out makes it
          // serialise the wgmmas (C7514)
          ptx::wgmma_wait<1>();
          if (prev >= 0) ptx::mbar_arrive(empty + prev);
          prev = slot;
          if (++slot == P.ring) {
            slot = 0;
            phase ^= 1;
          }
        }
      ptx::wgmma_wait<0>();
      if (prev >= 0) ptx::mbar_arrive(empty + prev);
#pragma unroll
      for (int r = 0; r < T::kYPW; ++r) retire<kCm>(acc[r]);
      // every consumer is done with the y slot's old plane (read by the last
      // step's stage 2)
      ptx::named_barrier(1, 128 * kNWG);
      // E1 and bf16 into y slot J % 3; zero outside the volume
      unsigned char* yd = ys + (J % kYSlots) * T::kYBytes;
#pragma unroll
      for (int r = 0; r < T::kYPW; ++r) {
        const int yr = wg + kNWG * r, ah = it.h0 - 1 + yr;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int c = col + 8 * half, aw = it.w0 - 1 + c;
          const bool inside = kd1 > kd0 && ah >= 0 && ah < P.H && aw >= 0 && aw < P.W;
#pragma unroll
          for (int jn = 0; jn < kCm / 8; ++jn) {
            float v0 = 0.f, v1 = 0.f;
            if (inside) {
              v0 = acc[r][4 * jn + 2 * half] * sc1[2 * jn] + bi1[2 * jn];
              v1 = acc[r][4 * jn + 2 * half + 1] * sc1[2 * jn + 1] + bi1[2 * jn + 1];
              if (P.relu1) {
                v0 = fmaxf(v0, 0.f);
                v1 = fmaxf(v1, 0.f);
              }
            }
            *reinterpret_cast<__nv_bfloat162*>(yd + ((size_t)jn * T::kYRows + yr * kPitch + c) * 16 +
                                               4 * t4) = __floats2bfloat162_rn(v0, v1);
          }
        }
      }
      ptx::fence_proxy_async();  // the y stores, before wgmma reads them
      ptx::named_barrier(1, 128 * kNWG);
      if (j < 2) continue;
      // ---- stage 2: output plane dy - 1 from y planes dy - 2 .. dy ----
      float acc2[T::kOPW][N2 / 2];
      ptx::wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < 3; ++kd) {
        const uint64_t ydesc =
            ptx::wgmma_desc(ys + ((J - 2 + kd) % kYSlots) * T::kYBytes, T::kYRows * 16, 128);
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
#pragma unroll
          for (int ks = 0; ks < kCm / 16; ++ks)
#pragma unroll
            for (int r = 0; r < T::kOPW; ++r) {
              const int orow = wg + kNWG * r;
              ptx::wgmma_ss<N2>(acc2[r], ydesc + (orow + tap / 3) * kPitch + tap % 3 + 2 * ks * T::kYRows,
                                k2desc + (uint64_t)((kd * 9 + tap) * 2 + ks) * (2 * N2), kd | tap | ks);
            }
      }
      ptx::wgmma_commit();
      // the output's voxels and adds (ctx, residual: channel pairs as raw
      // bf16x2), loaded while the products run
      const int od = dy - 1;
      long long vox[T::kOPW][2];
      unsigned cadd[T::kOPW][2][N2 / 8], radd[T::kOPW][2][N2 / 8];
#pragma unroll
      for (int r = 0; r < T::kOPW; ++r) {
        const int oh = it.h0 + wg + kNWG * r;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int ow = it.w0 + col + 8 * half;
          const bool in = col + 8 * half < kTW && ow < P.W && oh < P.H;
          vox[r][half] = in ? (((long long)it.b * P.D + od) * P.H + oh) * P.W + ow : -1;
          const long long cvox = ((long long)it.b * P.H + oh) * P.W + ow;
#pragma unroll
          for (int jn = 0; jn < N2 / 8; ++jn) {
            const int ch = 8 * jn + 2 * t4;
            cadd[r][half][jn] = radd[r][half][jn] = 0;
            if (in && ch < P.Cout) {
              if (P.ctx)
                cadd[r][half][jn] = P.Cout == 1 ? __bfloat16_as_ushort(P.ctx[cvox])
                                                : *reinterpret_cast<const unsigned*>(P.ctx + cvox * P.Cout + ch);
              if (P.residual)
                radd[r][half][jn] = P.Cout == 1 ? __bfloat16_as_ushort(P.x[vox[r][half] * P.Cin])
                                                : *reinterpret_cast<const unsigned*>(P.x + vox[r][half] * P.Cin + ch);
            }
          }
        }
      }
      ptx::wgmma_wait<0>();
#pragma unroll
      for (int r = 0; r < T::kOPW; ++r) retire<N2>(acc2[r]);
#pragma unroll
      for (int r = 0; r < T::kOPW; ++r)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (vox[r][half] < 0) continue;
          bf16* o = P.out + vox[r][half] * P.Cout;
#pragma unroll
          for (int jn = 0; jn < N2 / 8; ++jn) {
            const int ch = 8 * jn + 2 * t4;
            if (ch >= P.Cout) continue;
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              v[e] = acc2[r][4 * jn + 2 * half + e] * sc2[2 * jn + e] + bi2[2 * jn + e];
              if (P.relu2) v[e] = fmaxf(v[e], 0.f);
              // a bf16 is the high half of the f32 with the same bits
              const unsigned c = cadd[r][half][jn], x = radd[r][half][jn];
              v[e] += __uint_as_float(e ? c & 0xffff0000u : c << 16) + __uint_as_float(e ? x & 0xffff0000u : x << 16);
            }
            if (P.Cout == 1)
              o[0] = __float2bfloat16(v[0]);
            else
              *reinterpret_cast<__nv_bfloat162*>(o + ch) = __floats2bfloat162_rn(v[0], v[1]);
          }
        }
    }
  }
}

// x as a 5-D tensor map (C, W, H, D, B innermost first) whose box is one
// stage's 8-channel chunk: 8 channels x 66 columns x TH + 4 rows of one plane
bool x_tensor_map(CUtensorMap* map, const Params& P, int th) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                              const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                              CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &q);
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess || !fn) return false;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t e = sizeof(bf16);
  const cuuint64_t dims[5] = {(cuuint64_t)P.Cin, (cuuint64_t)P.W, (cuuint64_t)P.H, (cuuint64_t)P.D,
                              (cuuint64_t)P.B};
  const cuuint64_t strides[4] = {P.Cin * e, (cuuint64_t)P.W * P.Cin * e,
                                 (cuuint64_t)P.H * P.W * P.Cin * e, (cuuint64_t)P.D * P.H * P.W * P.Cin * e};
  const cuuint32_t box[5] = {8, (cuuint32_t)kPitch, (cuuint32_t)(th + 4), 1, 1};
  const cuuint32_t step[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<bf16*>(P.x), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int TH, int N2>
cudaError_t run(const Params& P, const CUtensorMap& xmap, int grid, long long smem, cudaStream_t stream) {
  auto kernel = fused_pair_wgmma_kernel<TH, N2>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<(unsigned)(grid < P.items ? grid : P.items), kThreads, (size_t)smem, stream>>>(P, xmap);
  return cudaGetLastError();
}

}  // namespace pair_wg
}  // namespace

// The tensor-core route, bf16 only, tiled by the wrapper's plan
// (cuda_fused_agg.pair_plan): th output rows (2, or 4 where N2 is 8) a tile,
// a D slab of sd planes, `ring` x stages, k1 resident in shared memory or
// streamed with x, `grid` persistent blocks, `smem` bytes a block (checked
// against the kernel's own count). k1 and k2 are packed by
// cuda_gband.pack_conv_wgmma: k1 [27][ceil(Cin / 16)][4][2][8][8], k2
// [27][2][N2 / 8][2][8][8] with N2 = Cout rounded up to 8, 16 or 32; pads
// zero. Cm is 32; Cin % 8 == 0; Cout == 1 or a multiple of 8 up to 32.
// scale/bias f32; ctx may be null. x, k1 and k2 16-byte aligned.
extern "C" int ecm_fused_conv3d_pair_wgmma(
    const void* x, const void* k1, const void* s1, const void* b1, const void* k2,
    const void* s2, const void* b2, const void* ctx, void* out, int B, int D, int H, int W,
    int Cin, int Cout, int relu1, int relu2, int residual, int th, int sd, int ring,
    int resident, int grid, long long smem, void* stream) {
  namespace pw = pair_wg;
  const int n2 = Cout <= 8 ? 8 : Cout <= 16 ? 16 : 32;
  if (Cin % 8 || !(Cout == 1 || (Cout % 8 == 0 && Cout <= 32)) || !(th == 2 || th == 4) ||
      (th == 4 && n2 > 8) || sd < 1 || ring < 2 || ring > pw::kMaxRing || grid < 1)
    return cudaErrorInvalidValue;
  using pw::bf16;
  pw::Params P;
  P.x = static_cast<const bf16*>(x);
  P.k1 = static_cast<const bf16*>(k1);
  P.s1 = static_cast<const float*>(s1);
  P.b1 = static_cast<const float*>(b1);
  P.k2 = static_cast<const bf16*>(k2);
  P.s2 = static_cast<const float*>(s2);
  P.b2 = static_cast<const float*>(b2);
  P.ctx = static_cast<const bf16*>(ctx);
  P.out = static_cast<bf16*>(out);
  P.B = B; P.D = D; P.H = H; P.W = W;
  P.Cin = Cin; P.Cout = Cout;
  P.ks1 = (Cin + 15) / 16;
  P.relu1 = relu1; P.relu2 = relu2; P.residual = residual; P.resident = resident ? 1 : 0;
  P.sd = sd;
  P.nsd = (D + sd - 1) / sd;
  P.nth = (H + th - 1) / th;
  P.ntw = (W + pw::kTW - 1) / pw::kTW;
  P.ring = ring;
  P.items = (long long)B * P.nsd * P.nth * P.ntw;
  if (smem != pw::smem_bytes(th, P.ks1, n2, P.resident, ring) || smem > pw::kSmemMax)
    return cudaErrorInvalidValue;
  CUtensorMap xmap;
  if (!pw::x_tensor_map(&xmap, P, th)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (th == 4) return pw::run<4, 8>(P, xmap, grid, smem, s);
  if (n2 == 8) return pw::run<2, 8>(P, xmap, grid, smem, s);
  return n2 == 16 ? pw::run<2, 16>(P, xmap, grid, smem, s) : pw::run<2, 32>(P, xmap, grid, smem, s);
}
