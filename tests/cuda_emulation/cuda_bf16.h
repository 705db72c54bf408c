// bf16 for the host emulation: round to nearest even, as the card converts.
#pragma once
#include "cuda_runtime.h"

struct __nv_bfloat16 { uint16_t x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };  // x in the low half

inline float __bfloat162float(__nv_bfloat16 b) {
  const uint32_t u = uint32_t(b.x) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

inline __nv_bfloat16 __float2bfloat16(float f) {
  if (std::isnan(f)) return {uint16_t(0x7fc0)};
  uint32_t u;
  std::memcpy(&u, &f, 4);
  u += 0x7fff + ((u >> 16) & 1);
  return {uint16_t(u >> 16)};
}

inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16(a), __float2bfloat16(b)};
}

inline float2 __bfloat1622float2(__nv_bfloat162 v) {
  return {__bfloat162float(v.x), __bfloat162float(v.y)};
}
