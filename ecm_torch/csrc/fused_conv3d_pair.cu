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
// (0.082 ms at 3.35 TB/s).
//
// Two routes, chosen by the wrapper (ops/cuda_fused_agg.py, pair_route):
//
// 1. fused_pair_mma_kernel, the tensor cores: bf16, Cin % 8 == 0, Cm == 32,
//    Cout == 1 or a multiple of 8 up to 32 (every form a path of the port
//    launches). Both stages are implicit GEMMs on mma.sync m16n8k16 (bf16 in,
//    f32 accumulate) with operands read by ldmatrix from shared memory:
//    stage 1 M = the 10x18 = 180 y positions of an 8x16 (H, W) tile and its
//    halo (12 m-tiles, rows 180..191 repeat row 179 and are dropped), N = 32,
//    K = 27 x Cin; stage 2 M = the tile's 128 outputs (one tile row of 16 per
//    warp), N = Cout padded to 8 (the classifier wastes 7/8 of a 2.5 GFLOP
//    stage: cheaper than a CUDA-core stage 2 beside tensor-core stage 1),
//    K = 27 x 32, its A operand read straight from the y ring.
//    A block owns one tile and marches along a slab of SD output planes in D
//    (SD = D / ceil(D / 16) rounded up): each step computes one new y plane
//    into a ring of three, then one output plane from the ring. Stage 1's
//    recompute is 180/128 x (SD + 2)/SD = 1.58 at SD = 16 (the CUDA-core
//    route's 4x8x16 tile: 2.11). x and k1 stream through a two-stage
//    cp.async ring, one stage per (kd, 32 input channels): an x plane of the
//    12x20 tile, zero-filled outside the volume and past Cin, and that kd's
//    9 taps of k1; the next stage's copies are in flight during the current
//    stage's MMAs. k2 is loaded once per block. Every operand row is 32 bf16
//    at a pitch of 40 (80 bytes: the eight rows of an ldmatrix hit distinct
//    banks). 256 threads, 8 warps: stage 1 splits 4 (m) x 2 (n), 3 m-tiles x
//    2 n-tiles a warp. The f32 epilogue (scale, bias, ReLU, then ctx and the
//    residual) stores each thread's channel pairs from the accumulator
//    registers (4 bytes; a staging pass for 16-byte rows would cost 18 KB of
//    shared memory and a barrier, for 2-4 % of the bytes the kernel moves).
//    Shared memory per block (bf16): x 2 x 240 x 40 + k1 2 x 9 x 32 x 40
//    (84,480 B) + y 3 x 180 x 40 (43,200 B) + k2 27 x Cout_pad x 40:
//      dres0 (Cin 64, two stages per kd) and dres1, Cout 32: 196,800 B
//      classif3, Cout 1 -> 8:                               144,960 B
//    of the 232,448 a block may have; one block per SM, 720 blocks at B=1.
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

#include "mma_sync.cuh"

namespace {
namespace pair_mma {

using bf16 = __nv_bfloat16;
using ecm::ptx::cp_async16;
using ecm::ptx::cp_async_commit;
using ecm::ptx::cp_async_wait;
using ecm::ptx::ldmatrix_x4;
using ecm::ptx::mma_m16n8k16;

constexpr int kThreads = 256;
constexpr int kTH = 8, kTW = 16;             // output tile in (H, W)
constexpr int kYH = kTH + 2, kYW = kTW + 2;  // y over the tile and its halo
constexpr int kXH = kTH + 4, kXW = kTW + 4;  // the x under that y
constexpr int kPY = kYH * kYW;               // 180 y rows
constexpr int kPX = kXH * kXW;               // 240 x rows
constexpr int kCm = 32;                      // stage-1 channels (N of stage 1, K per tap of stage 2)
constexpr int kKC = 32;                      // input channels per stage of the x ring
constexpr int kLD = 40;                      // row pitch (bf16) of every shared operand
constexpr int kXS = kPX * kLD;               // x elements per ring stage
constexpr int kW1S = 9 * kCm * kLD;          // k1 elements per ring stage (9 taps of one kd)
constexpr int kYS = kPY * kLD;               // elements per y plane

struct Params {
  const bf16* x;    // [B, D, H, W, Cin]
  const bf16* k1;   // [3 kd][nch][9 taps][32 co][kLD], ci in 32 c + [0, 32), zero pads
  const float* s1;  // [32]
  const float* b1;
  const bf16* k2;   // [27 taps][Cout_pad][kLD], ci in [0, 32), zero pads
  const float* s2;  // [Cout]
  const float* b2;
  const bf16* ctx;  // [B, H, W, Cout] or null
  bf16* out;        // [B, D, H, W, Cout]
  int B, D, H, W, Cin, Cout, nch, relu1, relu2, residual;
  int sd, nsd, nh, nw;  // D slab, and the counts of slabs and tiles
};

__host__ __device__ constexpr size_t smem_bytes(int cout_pad) {
  return (size_t)(2 * (kXS + kW1S) + 3 * kYS + 27 * cout_pad * kLD) * sizeof(bf16);
}

template <int NT2>  // stage-2 n-tiles: Cout_pad / 8
__global__ void __launch_bounds__(kThreads, 1) fused_pair_mma_kernel(const Params P) {
  constexpr int NP = 8 * NT2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [2][kPX][kLD]
  bf16* w1s = xs + 2 * kXS;                       // [2][9][32][kLD]
  bf16* ys = w1s + 2 * kW1S;                      // [3][kPY][kLD]
  bf16* k2s = ys + 3 * kYS;                       // [27][NP][kLD]

  int blk = blockIdx.x;
  const int w0 = (blk % P.nw) * kTW;
  blk /= P.nw;
  const int h0 = (blk % P.nh) * kTH;
  blk /= P.nh;
  const int d0 = (blk % P.nsd) * P.sd;
  const int b = blk / P.nsd;
  const int nd = min(P.sd, P.D - d0);  // output planes of this slab
  const int per_plane = 3 * P.nch;     // ring stages per y plane: (kd, channel chunk)
  const int stages = (nd + 2) * per_plane;  // y planes d0 - 1 .. d0 + nd
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // stage s: y plane j = s / per_plane (depth d0 - 1 + j), tap plane kd, chunk
  // c; it reads x plane d0 - 2 + j + kd. It is skipped (no copies, no MMAs)
  // when that y plane or that x plane lies outside the volume.
  auto active = [&](int s) {
    const int j = s / per_plane, kd = (s / P.nch) % 3;
    const int dy = d0 - 1 + j, id = dy + kd - 1;
    return dy >= 0 && dy < P.D && id >= 0 && id < P.D;
  };
  auto issue = [&](int s) {
    if (active(s)) {
      const int j = s / per_plane, kd = (s / P.nch) % 3, c = s % P.nch;
      const int id = d0 - 2 + j + kd;
      bf16* xd = xs + (s & 1) * kXS;
      bf16* wd = w1s + (s & 1) * kW1S;
      for (int i = tid; i < kPX * 4; i += kThreads) {
        const int row = i >> 2, q = i & 3;
        const int ih = h0 - 2 + row / kXW, iw = w0 - 2 + row % kXW, ci = c * kKC + 8 * q;
        const bool ok = ih >= 0 && ih < P.H && iw >= 0 && iw < P.W && ci < P.Cin;
        const bf16* src =
            ok ? P.x + ((((size_t)b * P.D + id) * P.H + ih) * P.W + iw) * P.Cin + ci : P.x;
        cp_async16(xd + row * kLD + 8 * q, src, ok);
      }
      const bf16* ws = P.k1 + (size_t)(kd * P.nch + c) * kW1S;
      for (int i = tid; i < kW1S / 8; i += kThreads) cp_async16(wd + 8 * i, ws + 8 * i, true);
    }
    cp_async_commit();
  };

  // k2 once, in the first group
  for (int i = tid; i < 27 * NP * kLD / 8; i += kThreads) cp_async16(k2s + 8 * i, P.k2 + 8 * i, true);
  issue(0);

  // ldmatrix row addresses of this lane: A row lr at k offset lk; B row
  // (output channel) bn at k offset bk
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lk = (lane >> 4) * 8;
  const int bn = lane & 7, bk = 8 * (lane >> 3);
  const int g = lane >> 2, t = lane & 3;
  // stage 1: warp (wm, wn) owns m-tiles wm, wm + 4, wm + 8 and n-tiles 2 wn, 2 wn + 1
  const int wm = warp & 3, wn = warp >> 2;
  int arow[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int p = min(16 * (wm + 4 * i) + lr, kPY - 1);
    arow[i] = (p / kYW) * kXW + p % kYW;  // the x row under y row p at tap (0, 0)
  }
  float acc1[3][2][4];

  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages)
      issue(s + 1);
    else
      cp_async_commit();
    cp_async_wait<1>();  // stage s (and k2) have landed
    __syncthreads();
    const int j = s / per_plane, r = s % per_plane;
    if (r == 0) {
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc1[i][n][e] = 0.f;
    }
    if (active(s)) {
      const bf16* xb = xs + (s & 1) * kXS;
      const bf16* wb = w1s + (s & 1) * kW1S;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int off = (tap / 3) * kXW + tap % 3;
        unsigned bf[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
          ldmatrix_x4(bf[n], wb + (tap * kCm + 8 * (2 * wn + n) + bn) * kLD + bk);
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            unsigned a[4];
            ldmatrix_x4(a, xb + (arow[i] + off) * kLD + 16 * ks + lk);
#pragma unroll
            for (int n = 0; n < 2; ++n) mma_m16n8k16(acc1[i][n], a, bf[n][2 * ks], bf[n][2 * ks + 1]);
          }
      }
    }
    if (r == per_plane - 1) {
      // y plane j into ring slot j % 3: E1, zero outside the volume, bf16
      const int dy = d0 - 1 + j;
      bf16* yd = ys + (j % 3) * kYS;
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = 16 * (wm + 4 * i) + g + 8 * half;
          if (p >= kPY) continue;
          const int ah = h0 - 1 + p / kYW, aw = w0 - 1 + p % kYW;
          const bool inside = dy >= 0 && dy < P.D && ah >= 0 && ah < P.H && aw >= 0 && aw < P.W;
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const int c = 8 * (2 * wn + n) + 2 * t;
            float v0 = 0.f, v1 = 0.f;
            if (inside) {
              v0 = acc1[i][n][2 * half] * __ldg(P.s1 + c) + __ldg(P.b1 + c);
              v1 = acc1[i][n][2 * half + 1] * __ldg(P.s1 + c + 1) + __ldg(P.b1 + c + 1);
              if (P.relu1) {
                v0 = fmaxf(v0, 0.f);
                v1 = fmaxf(v1, 0.f);
              }
            }
            *reinterpret_cast<__nv_bfloat162*>(yd + p * kLD + c) = __floats2bfloat162_rn(v0, v1);
          }
        }
      if (j >= 2) {
        __syncthreads();  // y plane j is in the ring
        // output plane od = d0 + j - 2 from y planes j - 2, j - 1, j; warp =
        // tile row, its 16 columns one m-tile
        float acc2[NT2][4];
#pragma unroll
        for (int n = 0; n < NT2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc2[n][e] = 0.f;
#pragma unroll
        for (int kd = 0; kd < 3; ++kd) {
          const bf16* yb = ys + ((j - 2 + kd) % 3) * kYS;
#pragma unroll
          for (int tap = 0; tap < 9; ++tap) {
            const bf16* ar = yb + ((warp + tap / 3) * kYW + lr + tap % 3) * kLD + lk;
            unsigned a0[4], a1[4];
            ldmatrix_x4(a0, ar);
            ldmatrix_x4(a1, ar + 16);
#pragma unroll
            for (int n = 0; n < NT2; ++n) {
              unsigned bb[4];
              ldmatrix_x4(bb, k2s + ((kd * 9 + tap) * NP + 8 * n + bn) * kLD + bk);
              mma_m16n8k16(acc2[n], a0, bb[0], bb[1]);
              mma_m16n8k16(acc2[n], a1, bb[2], bb[3]);
            }
          }
        }
        const int od = d0 + j - 2, oh = h0 + warp;
        if (oh < P.H) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int ow = w0 + g + 8 * half;
            if (ow >= P.W) continue;
            const size_t vox = (((size_t)b * P.D + od) * P.H + oh) * P.W + ow;
            const size_t cvox = ((size_t)b * P.H + oh) * P.W + ow;
#pragma unroll
            for (int n = 0; n < NT2; ++n) {
              const int c = 8 * n + 2 * t;
              if (c >= P.Cout) continue;
              float v[2] = {acc2[n][2 * half], acc2[n][2 * half + 1]};
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                if (c + e >= P.Cout) continue;
                v[e] = v[e] * __ldg(P.s2 + c + e) + __ldg(P.b2 + c + e);
                if (P.relu2) v[e] = fmaxf(v[e], 0.f);
                if (P.ctx) v[e] += __bfloat162float(P.ctx[cvox * P.Cout + c + e]);
                if (P.residual) v[e] += __bfloat162float(P.x[vox * P.Cin + c + e]);
              }
              if (P.Cout == 1)
                P.out[vox] = __float2bfloat16(v[0]);
              else
                *reinterpret_cast<__nv_bfloat162*>(P.out + vox * P.Cout + c) =
                    __floats2bfloat162_rn(v[0], v[1]);
            }
          }
        }
      }
    }
    __syncthreads();  // ring stage s and the y slot read above are free again
  }
}

template <int NT2>
cudaError_t launch(const Params& P, cudaStream_t stream) {
  const size_t smem = smem_bytes(8 * NT2);
  auto kernel = fused_pair_mma_kernel<NT2>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)P.B * P.nsd * P.nh * P.nw;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(P);
  return cudaGetLastError();
}

}  // namespace pair_mma
}  // namespace

// The tensor-core route, bf16 only. k1 and k2 are packed by the wrapper
// (cuda_fused_agg.pack_pair_mma) into the shared-memory images above: k1
// [3][ceil(Cin/32)][9][32][40], k2 [27][Cout_pad][40], Cout_pad = 8 for
// Cout == 1, else Cout; pads zero. Cm is 32; Cin % 8 == 0; Cout == 1 or a
// multiple of 8 up to 32. scale/bias f32; ctx may be null; sd is the D slab.
extern "C" int ecm_fused_conv3d_pair_mma(
    const void* x, const void* k1, const void* s1, const void* b1, const void* k2,
    const void* s2, const void* b2, const void* ctx, void* out, int B, int D, int H, int W,
    int Cin, int Cout, int relu1, int relu2, int residual, int sd, void* stream) {
  namespace pm = pair_mma;
  if (Cin % 8 || !(Cout == 1 || (Cout % 8 == 0 && Cout <= 32)) || sd < 1)
    return cudaErrorInvalidValue;
  using pm::bf16;
  pm::Params P;
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
  P.nch = (Cin + pm::kKC - 1) / pm::kKC;
  P.relu1 = relu1; P.relu2 = relu2; P.residual = residual;
  P.sd = sd;
  P.nsd = (D + sd - 1) / sd;
  P.nh = (H + pm::kTH - 1) / pm::kTH;
  P.nw = (W + pm::kTW - 1) / pm::kTW;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Cout == 1 ? 1 : Cout / 8) {
    case 1: return pm::launch<1>(P, s);
    case 2: return pm::launch<2>(P, s);
    case 3: return pm::launch<3>(P, s);
    default: return pm::launch<4>(P, s);
  }
}
