// CPU stand-in for cuda_bf16.h: bf16 as 16 bits, rounded to nearest even.
#pragma once
#include "cuda_runtime.h"
struct __nv_bfloat16 { unsigned short x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat16 __float2bfloat16(float f) {
  unsigned u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(unsigned short)0x7fc0};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(unsigned short)(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 b) { return __uint_as_float((unsigned)b.x << 16); }
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) { return {__float2bfloat16(a), __float2bfloat16(b)}; }
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 b) { return b.x; }
