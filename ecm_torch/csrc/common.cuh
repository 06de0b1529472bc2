// Device helpers shared by the port's convolution kernels (header only).
//
// Activations are NDHWC in bf16 or f32; weights arrive as f32 [taps][Cin][Cout_pad]
// (already rounded to the activation type by the wrapper) and are read through
// the read-only cache; all arithmetic is f32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ecm {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 16-byte vectors of N consecutive values: load widened to f32, store from f32,
// or keep the raw 16 bytes and widen one element at a time (at, with n a
// constant once the caller's loop is unrolled).
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* o) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ static float at(const uint4& r, int n) {
    return __uint_as_float(n == 0 ? r.x : n == 1 ? r.y : n == 2 ? r.z : r.w);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  // a bf16 is the high half of the f32 with the same bits
  __device__ static float at(const uint4& r, int n) {
    const unsigned w = (n / 2 == 0) ? r.x : (n / 2 == 1) ? r.y : (n / 2 == 2) ? r.z : r.w;
    return __uint_as_float(n % 2 == 0 ? w << 16 : w & 0xffff0000u);
  }
  __device__ static void load(const __nv_bfloat16* p, float* o) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
#pragma unroll
    for (int n = 0; n < N; ++n) o[n] = at(u, n);
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = (unsigned)__bfloat16_as_ushort(__float2bfloat16(v[2 * k])) |
             ((unsigned)__bfloat16_as_ushort(__float2bfloat16(v[2 * k + 1])) << 16);
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// acc[0:CO] += xv * w[0:CO], w 16-byte aligned, CO a multiple of 4.
template <int CO>
__device__ __forceinline__ void fma_strip(float* acc, float xv, const float* w) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int k = 0; k < CO / 4; ++k) {
    const float4 q = __ldg(w4 + k);
    acc[4 * k] += xv * q.x;
    acc[4 * k + 1] += xv * q.y;
    acc[4 * k + 2] += xv * q.z;
    acc[4 * k + 3] += xv * q.w;
  }
}

// acc[j][0:CO] += xv[j] * wr[0:CO] for each of VX voxels: one weight row,
// read once, feeds VX FMAs per channel.
template <int VX, int CO>
__device__ __forceinline__ void fma_rows(float (&acc)[VX][CO], const float (&xv)[VX], const float* wr) {
  float4 q[CO / 4];
#pragma unroll
  for (int k = 0; k < CO / 4; ++k) q[k] = __ldg(reinterpret_cast<const float4*>(wr) + k);
#pragma unroll
  for (int j = 0; j < VX; ++j)
#pragma unroll
    for (int k = 0; k < CO / 4; ++k) {
      acc[j][4 * k] += xv[j] * q[k].x;
      acc[j][4 * k + 1] += xv[j] * q[k].y;
      acc[j][4 * k + 2] += xv[j] * q[k].z;
      acc[j][4 * k + 3] += xv[j] * q[k].w;
    }
}

// One tap of a convolution for VX output voxels and a strip of CO output
// channels: acc[j][c] += sum_ci x_j[ci] * w[ci][c], where xp[j] points at
// input row x_j (Cin values) or is null for a voxel whose tap lies in the zero
// padding, and w points at [Cin][cout_pad] already offset to the strip. Each
// weight row (CO floats, the same address in every thread of the block: a
// broadcast) feeds VX FMAs per channel. vec: Cin is a multiple of Vec<T>::N and
// every row is 16-byte aligned, so x is read 16 bytes at a time.
template <typename T, int VX, int CO>
__device__ __forceinline__ void accumulate_tap(float (&acc)[VX][CO], const T* const (&xp)[VX],
                                               const float* w, int cin, int cout_pad, bool vec) {
  constexpr int N = Vec<T>::N;
  if (vec) {
    for (int ci = 0; ci < cin; ci += N) {
      uint4 raw[VX];
#pragma unroll
      for (int j = 0; j < VX; ++j)
        raw[j] = xp[j] ? __ldg(reinterpret_cast<const uint4*>(xp[j] + ci)) : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int n = 0; n < N; ++n) {
        float xv[VX];
#pragma unroll
        for (int j = 0; j < VX; ++j) xv[j] = Vec<T>::at(raw[j], n);
        fma_rows<VX, CO>(acc, xv, w + (size_t)(ci + n) * cout_pad);
      }
    }
  } else {
    for (int ci = 0; ci < cin; ++ci) {
      float xv[VX];
#pragma unroll
      for (int j = 0; j < VX; ++j) xv[j] = xp[j] ? to_f32(xp[j][ci]) : 0.f;
      fma_rows<VX, CO>(acc, xv, w + (size_t)ci * cout_pad);
    }
  }
}

// Epilogue of channels c0..c0+CO-1 of one output voxel:
//   out[c] = relu?(acc[c] * scale[c] + bias[c]) [+ add[c]]   (f32, one rounding)
// scale may be null (a scale of 1); out and add point at channel c0 of the
// voxel's row; add may be null. vec:
// the whole strip lies inside Cout and the rows are 16-byte aligned.
template <typename T, int CO>
__device__ __forceinline__ void epilogue(const float* acc, const float* scale, const float* bias,
                                         int c0, int cout, bool relu, const T* add, T* out,
                                         bool vec) {
  constexpr int N = Vec<T>::N;
  float v[CO];
#pragma unroll
  for (int c = 0; c < CO; ++c) {
    const int co = c0 + c < cout ? c0 + c : cout - 1;  // pad channels: computed, never stored
    v[c] = (scale ? acc[c] * __ldg(scale + co) : acc[c]) + __ldg(bias + co);
    if (relu) v[c] = fmaxf(v[c], 0.f);
  }
  if (vec) {
#pragma unroll
    for (int k = 0; k < CO / N; ++k) {
      if (add) {
        float a[N];
        Vec<T>::load(add + k * N, a);
#pragma unroll
        for (int n = 0; n < N; ++n) v[k * N + n] += a[n];
      }
      Vec<T>::store(out + k * N, v + k * N);
    }
  } else {
#pragma unroll
    for (int c = 0; c < CO; ++c)
      if (c0 + c < cout) out[c] = from_f32<T>(add ? v[c] + to_f32(add[c]) : v[c]);
  }
}

}  // namespace ecm
