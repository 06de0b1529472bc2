// Tensor-core implicit GEMM for the port's 3x3x3 convolutions on bf16 NDHWC
// tensors with Cin a multiple of 8, for Hopper (sm_90a). Header only:
// conv3d_bn.cu instantiates modes 1 and 2 (a convolution with zero padding 1
// and that stride), deconv3d_bn.cu kTransposed (ConvTranspose3d, kernel 3,
// stride 2, padding 1, output padding 1), where output o takes input i
// through tap k when o = 2i - 1 + k: per dim an even output o = 2m has the
// one tap (k=1, i=m) and an odd one o = 2m+1 the taps (k=2, i=m) and (k=0,
// i=m+1), the latter zero past the last input.
//
//   out = relu?(conv(x, w) * scale + bias) [+ add]     f32 accumulation and
//   epilogue, one rounding at the store
//
// What bounds it: the main paths' convolutions need 10-160 GFLOP against
// 115-276 MB of compulsory traffic, so every input byte has to feed many
// products from on-chip memory. The design:
//
// - Persistent blocks, one per SM (the wrapper's plan, ops/cuda_gband.py
//   conv_plan, gives the grid). Each loads the whole packed weight
//   [27][Cin_pad / 16][Cout_pad / 8][2][8][8] (bf16, wgmma's K-major core
//   matrices, zero in the pads; 110,592 B at 64->32 or 32->64) into shared
//   memory once and keeps it for every work item.
// - A work item is an (H, W) tile and a slab of steps along D: a step is one
//   output plane (modes 1, 2) or one input plane m, which gives the output
//   planes 2m and 2m + 1 (kTransposed). The block reads the item's input
//   planes in order, each once, into a ring of `ring` slots. A slot holds
//   the tile's input rows with their halo, zero outside the volume and past
//   Cin, channel-chunk major: [Cin_pad / 8][rows][8 channels], so that any
//   8 consecutive rows of one chunk are one of wgmma's 128-byte core
//   matrices. A plane serves up to 3 steps x 9 taps (mode 1), 1-2 steps
//   (mode 2) or 2 steps x 8 parity classes (kTransposed); a tap is an offset
//   of the A descriptor's start, not a load.
// - Warp specialisation: a producer warpgroup fills the ring with cp.async
//   (16 bytes a thread, source size 0 in the padding) and signals each
//   slot's `full` mbarrier through cp.async.mbarrier.arrive; it waits on the
//   slot's `empty` mbarrier, on which every consumer thread arrives once the
//   products that read the plane have retired. Every branch around a wgmma
//   is warp-uniform in a way the compiler can see (roles from a shuffled warp
//   index, barrier waits inside one asm statement, no lane-dependent exits):
//   otherwise ptxas serialises the wgmmas. So the loads of the next
//   planes, and of the next item's, run under the products of the current.
// - Consumers: NWG warpgroups, each one tile row of 64 voxels along W
//   (M = 64). Per tap and 16 input channels one wgmma.mma_async m64nNk16
//   (N = Cout_pad: 16, 32 or 64) with A (the tap's 64 shifted rows) and B
//   (the resident weights) both read from shared memory through
//   descriptors; a step's products are issued back to back as one group.
//   The f32 accumulators stay in registers and the epilogue (scale, bias,
//   ReLU, add, bf16) stores from them.
// - Tiles: mode 1 is 2 x 64 outputs with a one-voxel halo (4 x 66 rows, two
//   warpgroups); mode 2 is 1 x 64 outputs over 3 x 129 input rows (one
//   warpgroup), the halo's even columns stored ahead of its odd ones so that
//   a tap's 64 rows (every other input column) are consecutive; kTransposed
//   is 2 x 64 inputs with a halo of one at the far side (3 x 65 rows), and
//   writes all eight parity classes of their 2 x 2 x 2 outputs, each class
//   one GEMM over its 1, 2, 4 or 8 legal taps (27 for the eight), two
//   classes in flight so that one's epilogue runs under the other's products.

#pragma once

#include "common.cuh"
#include "wgmma.cuh"

namespace ecm {
namespace wg {

using bf16 = __nv_bfloat16;

constexpr int kTransposed = 0;
constexpr int kSmemMax = 232448;  // dynamic shared memory an H100 block may have
constexpr int kMaxRing = 8;
constexpr int kBarBytes = 2 * kMaxRing * 8;  // full[kMaxRing], empty[kMaxRing] ahead of the weights
// B (the weights): from a core matrix to the next along K, and along N
constexpr int kLBO_B = 128, kSBO_B = 256;

template <int MODE>
struct Tile {
  static constexpr int TW = 64;                // tile width: one wgmma's M
  static constexpr int NWG = MODE == 2 ? 1 : 2;  // consumer warpgroups, one tile row each
  static constexpr int TH = NWG;               // tile rows: outputs (modes 1, 2), inputs (kTransposed)
  static constexpr int HR = MODE == 1 ? TH + 2 : MODE == 2 ? 2 * TH + 1 : TH + 1;
  static constexpr int HC = MODE == 1 ? TW + 2 : MODE == 2 ? 2 * TW + 1 : TW + 1;
  static constexpr int kRows = HR * HC;  // input rows of a ring slot
  static constexpr int kThreads = 128 * (NWG + 1);
};

struct Params {
  const bf16* x;       // [B, D, H, W, Cin]
  const bf16* w;       // packed, see above
  const float* scale;  // [Cout], or null (a scale of 1, folded into w)
  const float* bias;   // [Cout]
  const bf16* add;     // [B, add_d, Ho, Wo, Cout] with add_d in {1, Do}, or null
  bf16* out;           // [B, Do, Ho, Wo, Cout]
  int B, D, H, W, Cin, Cin_pad, Cout, Cout_pad, Do, Ho, Wo, add_d, relu;
  int sd, nslab, nth, ntw, ring;  // steps per item, tiling, ring slots
  long long items;
};

__host__ __device__ constexpr long long smem_bytes(int rows, int cin_pad, int cout_pad, int ring) {
  return kBarBytes + 27LL * cin_pad * cout_pad * 2 + (long long)ring * rows * cin_pad * 2;
}

// the first and last input plane that step s reads
template <int MODE>
__device__ __forceinline__ int plane_lo(int s) {
  return MODE == kTransposed ? s : max(s * MODE - 1, 0);
}
template <int MODE>
__device__ __forceinline__ int plane_hi(const Params& P, int s) {
  return min(MODE == kTransposed ? s + 1 : s * MODE + 1, P.D - 1);
}

struct Item {
  int b, h0, w0, s0, s1, lo, hi;  // tile origin, steps [s0, s1), input planes [lo, hi]
};

template <int MODE>
__device__ __forceinline__ Item item_at(const Params& P, long long i) {
  Item it;
  const int tw = (int)(i % P.ntw);
  i /= P.ntw;
  const int th = (int)(i % P.nth);
  i /= P.nth;
  const int slab = (int)(i % P.nslab);
  it.b = (int)(i / P.nslab);
  it.h0 = th * Tile<MODE>::TH;
  it.w0 = tw * Tile<MODE>::TW;
  it.s0 = slab * P.sd;
  it.s1 = min(it.s0 + P.sd, MODE == kTransposed ? P.D : P.Do);
  it.lo = plane_lo<MODE>(it.s0);
  it.hi = plane_hi<MODE>(P, it.s1 - 1);
  return it;
}

// The slot row of halo row hr, column hc (mode 2: even columns first).
template <int MODE>
__device__ __forceinline__ int slot_row(int hr, int hc) {
  using T = Tile<MODE>;
  if constexpr (MODE == 2)
    return (hc & 1) ? T::HR * (T::TW + 1) + hr * T::TW + (hc >> 1) : hr * (T::TW + 1) + (hc >> 1);
  return hr * T::HC + hc;
}

// Producer: input plane p of the item into a ring slot, thread tp's share of
// the 128 producer threads; consecutive threads read consecutive 16 bytes.
template <int MODE>
__device__ __forceinline__ void load_plane(const Params& P, const Item& it, int p,
                                           unsigned char* dst, int tp) {
  using T = Tile<MODE>;
  const int nck = P.Cin_pad / 8;
  const bf16* xp = P.x + ((size_t)it.b * P.D + p) * P.H * P.W * P.Cin;
  for (int e = tp; e < T::kRows * nck; e += 128) {
    const int row = e / nck, q = e - row * nck;
    const int hr = row / T::HC, hc = row - hr * T::HC;
    int ih, iw;
    if constexpr (MODE == 1) {
      ih = it.h0 - 1 + hr;
      iw = it.w0 - 1 + hc;
    } else if constexpr (MODE == 2) {
      ih = 2 * it.h0 - 1 + hr;
      iw = 2 * it.w0 - 1 + hc;
    } else {
      ih = it.h0 + hr;
      iw = it.w0 + hc;
    }
    const int ci = 8 * q;
    const bool ok = ih >= 0 && ih < P.H && iw >= 0 && iw < P.W && ci < P.Cin;
    ptx::cp_async16(dst + ((size_t)q * T::kRows + slot_row<MODE>(hr, hc)) * 16,
                    ok ? xp + ((size_t)ih * P.W + iw) * P.Cin + ci : P.x, ok);
  }
}

// d = sum over the tap's k-steps of A (rows from `row` of the slot whose
// descriptor is adesc) x B (kernel tap k); acc: add to d (else start at 0).
template <int MODE, int N>
__device__ __forceinline__ void mma_tap(float (&d)[N / 2], uint64_t adesc, int row, uint64_t wdesc,
                                        int k, int nks, unsigned kdesc, int acc) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    if (ks < nks)
      ptx::wgmma_ss<N>(d, adesc + row + 2 * ks * Tile<MODE>::kRows,
                       wdesc + (uint64_t)(k * nks + ks) * kdesc, acc | ks);
}

template <int N>
__device__ __forceinline__ void retire(float (&d)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) ptx::fence_operand(d[i]);
}

// The epilogue rows of this thread in one step (or parity class): the output
// voxels of its accumulator rows g and g + 8 (-1 outside the volume), the
// add's voxels, and the add's channel pairs 8 j + 2 t4, loaded before the
// products retire so that their latency hides behind them.
template <int N>
struct Rows {
  long long vox[2], avox[2];
  unsigned add[2][N / 8];
};

template <int N>
__device__ __forceinline__ void load_add(const Params& P, Rows<N>& r, int t4) {
  if (!P.add || (P.Cout & 1)) return;
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int ch = 8 * j + 2 * t4;
      if (r.vox[half] >= 0 && ch < P.Cout)
        r.add[half][j] = __ldg(reinterpret_cast<const unsigned*>(P.add + r.avox[half] * P.Cout + ch));
    }
}

// out = relu?(acc * scale + bias) [+ add], rounded once, for both rows
// (scale and bias through the read-only cache: registers are scarce).
template <int N>
__device__ __forceinline__ void store_rows(const Params& P, const float (&acc)[N / 2],
                                           const Rows<N>& r, int t4) {
  const bool pairs = (P.Cout & 1) == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (r.vox[half] < 0) continue;
    bf16* o = P.out + r.vox[half] * P.Cout;
    const bf16* ad = P.add ? P.add + r.avox[half] * P.Cout : nullptr;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int ch = 8 * j + 2 * t4;
      if (ch >= P.Cout) continue;
      const int c1 = min(ch + 1, P.Cout - 1);  // an odd Cout's last pair: computed, not stored
      float v0 = acc[4 * j + 2 * half] * (P.scale ? __ldg(P.scale + ch) : 1.f) + __ldg(P.bias + ch);
      float v1 = acc[4 * j + 2 * half + 1] * (P.scale ? __ldg(P.scale + c1) : 1.f) + __ldg(P.bias + c1);
      if (P.relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      if (pairs) {
        if (ad) {
          const unsigned u = r.add[half][j];
          v0 += __uint_as_float(u << 16);
          v1 += __uint_as_float(u & 0xffff0000u);
        }
        *reinterpret_cast<__nv_bfloat162*>(o + ch) = __floats2bfloat162_rn(v0, v1);
      } else {
        o[ch] = __float2bfloat16(ad ? v0 + __bfloat162float(ad[ch]) : v0);
        if (ch + 1 < P.Cout)
          o[ch + 1] = __float2bfloat16(ad ? v1 + __bfloat162float(ad[ch + 1]) : v1);
      }
    }
  }
}

// The transposed mode's parity class cls = (pd, ph, pw) of input plane s:
// its taps per dim (1 for an even output, 2 for an odd one; the D tap of
// plane s + 1 only inside the volume), issued into d as one group.
template <int N>
__device__ __forceinline__ void deconv_class(float (&d)[N / 2], const Params& P, int s, int cls,
                                             const uint64_t (&adesc)[2], int wg, uint64_t wdesc,
                                             int nks, unsigned kdesc) {
  using T = Tile<kTransposed>;
  const int pd = cls >> 2, ph = (cls >> 1) & 1, pw = cls & 1;
  const int nd = pd && s + 1 < P.D ? 2 : 1, nh = ph ? 2 : 1, nw = pw ? 2 : 1;
  ptx::wgmma_fence();
  for (int ea = 0; ea < nd; ++ea)
    for (int eh = 0; eh < nh; ++eh)
      for (int ew = 0; ew < nw; ++ew) {
        const int kd = pd ? (ea ? 0 : 2) : 1, kh = ph ? (eh ? 0 : 2) : 1, kw = pw ? (ew ? 0 : 2) : 1;
        mma_tap<kTransposed, N>(d, adesc[ea], (wg + eh) * T::HC + ew, wdesc, (kd * 3 + kh) * 3 + kw,
                                nks, kdesc, ea | eh | ew);
      }
  ptx::wgmma_commit();
}

template <int MODE, int N>
__global__ void __launch_bounds__(Tile<MODE>::kThreads, 1) conv3d_wgmma_kernel(const Params P) {
  using T = Tile<MODE>;
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxRing;
  unsigned char* ws = smem + kBarBytes;
  const int wbytes = 27 * P.Cin_pad * N * 2;
  unsigned char* ring = ws + wbytes;
  const int chunk_bytes = T::kRows * 16;  // one 8-channel chunk of a slot: A's leading byte offset
  const int slot_bytes = P.Cin_pad / 8 * chunk_bytes;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);  // uniform, and seen so

  if (tid == 0) {
    for (int i = 0; i < P.ring; ++i) {
      ptx::mbar_init(full + i, 128);
      ptx::mbar_init(empty + i, 128 * T::NWG);
    }
    ptx::mbar_init_fence();
  }
  for (int i = tid; i < wbytes / 16; i += T::kThreads) ptx::cp_async16(ws + 16 * i, P.w + 8 * i, true);
  ptx::cp_async_commit();
  ptx::cp_async_wait<0>();
  ptx::fence_proxy_async();
  __syncthreads();

  if (warp >= 4 * T::NWG) {  // the producer warpgroup
    const int tp = tid - 128 * T::NWG;
    int j = 0;  // ring sequence number of the plane
    for (long long i = blockIdx.x; i < P.items; i += gridDim.x) {
      const Item it = item_at<MODE>(P, i);
      for (int p = it.lo; p <= it.hi; ++p, ++j) {
        const int slot = j % P.ring;
        if (j >= P.ring) ptx::mbar_wait(empty + slot, (j / P.ring - 1) & 1);
        load_plane<MODE>(P, it, p, ring + slot * slot_bytes, tp);
        ptx::cp_async_arrive(full + slot);
      }
    }
    ptx::cp_async_wait_all();
    return;
  }

  // consumers: warpgroup wg is tile row wg; warp (cw % 4) holds the
  // accumulator rows (tile columns) 16 (cw % 4) + g and + 8, channels 8 j +
  // 2 t4 (+ 1)
  const int cw = warp, wg = cw / 4, g = lane >> 2, t4 = lane & 3;
  const int col = 16 * (cw % 4) + g;
  const uint64_t wdesc = ptx::wgmma_desc(ws, kLBO_B, kSBO_B);
  const int nks = P.Cin_pad / 16;
  const unsigned kdesc = N * 2;  // one k-step of B, N x 16 bf16, in 16-byte units
  int j0 = 0;  // ring sequence number of the item's first plane
  for (long long i = blockIdx.x; i < P.items; i += gridDim.x) {
    const Item it = item_at<MODE>(P, i);
    // the A descriptor of plane p's slot (its rows 16 bytes apart, 8-row
    // core matrices 128 bytes apart, 8-channel chunks chunk_bytes apart)
    auto seq = [&](int p) { return j0 + p - it.lo; };
    auto plane = [&](int p) {
      const int j = seq(p);
      ptx::mbar_wait(full + j % P.ring, (j / P.ring) & 1);
      ptx::fence_proxy_async();
      return ptx::wgmma_desc(ring + (j % P.ring) * slot_bytes, chunk_bytes, 128);
    };
    int rel = it.lo;  // the next plane to hand back to the producer
    // hand back the planes before plane_lo(s + 1): step s has retired
    auto release = [&](int s) {
      const int next = s + 1 < it.s1 ? plane_lo<MODE>(s + 1) : it.hi + 1;
      for (; rel < next; ++rel) ptx::mbar_arrive(empty + seq(rel) % P.ring);
    };
    if constexpr (MODE == kTransposed) {
      for (int s = it.s0; s < it.s1; ++s) {
        // the eight parity classes of the outputs of input plane s
        float da[N / 2], db[N / 2];
        const uint64_t ad[2] = {plane(s), s + 1 < P.D ? plane(s + 1) : 0};
        const int ih = it.h0 + wg;
        // class c's epilogue rows and the add's values, loaded before it retires
        auto rows = [&](int c) {
          const int pd = c >> 2, ph = (c >> 1) & 1, pw = c & 1;
          Rows<N> r;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int iw = it.w0 + col + 8 * half;
            r.vox[half] = r.avox[half] =
                ih < P.H && iw < P.W
                    ? (((long long)it.b * P.Do + 2 * s + pd) * P.Ho + 2 * ih + ph) * P.Wo + 2 * iw + pw
                    : -1;
          }
          load_add<N>(P, r, t4);
          return r;
        };
        if constexpr (N <= 32) {
          // two classes in flight: class c + 1's products run under class c's epilogue
          deconv_class<N>(da, P, s, 0, ad, wg, wdesc, nks, kdesc);
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            float(&cur)[N / 2] = (c & 1) ? db : da;
            float(&nxt)[N / 2] = (c & 1) ? da : db;
            if (c + 1 < 8) deconv_class<N>(nxt, P, s, c + 1, ad, wg, wdesc, nks, kdesc);
            const Rows<N> r = rows(c);
            if (c + 1 < 8) {
              ptx::wgmma_wait<1>();
            } else {
              ptx::wgmma_wait<0>();
              release(s);
            }
            retire<N>(cur);
            store_rows<N>(P, cur, r, t4);
          }
        } else {  // one accumulator set: the registers of two do not fit
          for (int c = 0; c < 8; ++c) {
            deconv_class<N>(da, P, s, c, ad, wg, wdesc, nks, kdesc);
            const Rows<N> r = rows(c);
            ptx::wgmma_wait<0>();
            if (c == 7) release(s);
            retire<N>(da);
            store_rows<N>(P, da, r, t4);
          }
        }
      }
    } else {
      // step s's products into d, one group
      auto issue = [&](float(&d)[N / 2], int s) {
        ptx::wgmma_fence();
        // the taps' planes s * MODE - 1 + kd inside the volume: kd in [kd0, kd1)
        const int kd0 = s * MODE >= 1 ? 0 : 1, kd1 = min(3, P.D + 1 - s * MODE);
        for (int kd = kd0; kd < kd1; ++kd) {
          const uint64_t ad = plane(s * MODE + kd - 1);
#pragma unroll
          for (int kh = 0; kh < 3; ++kh)
#pragma unroll
            for (int kw = 0; kw < 3; ++kw) {
              const int row = MODE == 1 ? slot_row<1>(wg + kh, kw) : slot_row<2>(2 * wg + kh, kw);
              mma_tap<MODE, N>(d, ad, row, wdesc, (kd * 3 + kh) * 3 + kw, nks, kdesc,
                               kd > kd0 || kh || kw);
            }
        }
        ptx::wgmma_commit();
      };
      // step s's epilogue (the add's loads issued before the products retire)
      auto finish = [&](float(&d)[N / 2], int s) {
        Rows<N> r;
        const int oh = it.h0 + wg;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int ow = it.w0 + col + 8 * half;
          const bool in = oh < P.Ho && ow < P.Wo;
          r.vox[half] = in ? (((long long)it.b * P.Do + s) * P.Ho + oh) * P.Wo + ow : -1;
          r.avox[half] =
              (((long long)it.b * P.add_d + (P.add_d == 1 ? 0 : s)) * P.Ho + oh) * P.Wo + ow;
        }
        load_add<N>(P, r, t4);
        ptx::wgmma_wait<0>();
        retire<N>(d);
        release(s);
        store_rows<N>(P, d, r, t4);
      };
      float d[N / 2];
      for (int s = it.s0; s < it.s1; ++s) {
        issue(d, s);
        finish(d, s);
      }
    }
    j0 += it.hi - it.lo + 1;
  }
}

// Fill the derived fields of P (Cin_pad, Cout_pad, tiling, items) from its
// dims and the plan (sd, ring, grid, smem: ops/cuda_gband.py conv_plan),
// check the plan, and launch. P holds the input and output dims, pointers,
// Cin, Cout, add_d and relu.
template <int MODE>
cudaError_t launch(Params P, int sd, int ring, int grid, long long smem, cudaStream_t stream) {
  using T = Tile<MODE>;
  if (P.Cin % 8 || P.Cin > 64 || P.Cout < 1 || P.Cout > 64 || ring < 2 || ring > kMaxRing ||
      sd < 1 || grid < 1)
    return cudaErrorInvalidValue;
  P.Cin_pad = (P.Cin + 15) / 16 * 16;
  P.Cout_pad = P.Cout <= 16 ? 16 : P.Cout <= 32 ? 32 : 64;
  P.sd = sd;
  P.ring = ring;
  const int steps = MODE == kTransposed ? P.D : P.Do;
  P.nslab = (steps + sd - 1) / sd;
  P.nth = ((MODE == kTransposed ? P.H : P.Ho) + T::TH - 1) / T::TH;
  P.ntw = ((MODE == kTransposed ? P.W : P.Wo) + T::TW - 1) / T::TW;
  P.items = (long long)P.B * P.nslab * P.nth * P.ntw;
  if (smem != smem_bytes(T::kRows, P.Cin_pad, P.Cout_pad, ring) || smem > kSmemMax)
    return cudaErrorInvalidValue;
  auto run = [&](auto kernel) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    kernel<<<(unsigned)(grid < P.items ? grid : P.items), T::kThreads, (size_t)smem, stream>>>(P);
    return cudaGetLastError();
  };
  if (P.Cout_pad == 16) return run(conv3d_wgmma_kernel<MODE, 16>);
  if (P.Cout_pad == 32) return run(conv3d_wgmma_kernel<MODE, 32>);
  return run(conv3d_wgmma_kernel<MODE, 64>);
}

}  // namespace wg
}  // namespace ecm
