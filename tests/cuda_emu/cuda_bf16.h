// CPU stand-in for cuda_bf16.h: bf16 as its 16 bits, round to nearest even.
#pragma once
#include <cmath>
#include <cstdint>
#include <cstring>
struct __nv_bfloat16 { uint16_t v; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline float __bfloat162float(__nv_bfloat16 b) {
  uint32_t u = (uint32_t)b.v << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if (std::isnan(f)) return __nv_bfloat16{(uint16_t)((u >> 16) | 0x40)};
  u += 0x7fff + ((u >> 16) & 1);
  return __nv_bfloat16{(uint16_t)(u >> 16)};
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return __nv_bfloat162{__float2bfloat16_rn(a), __float2bfloat16_rn(b)};
}
inline float __low2float(__nv_bfloat162 v) { return __bfloat162float(v.x); }
inline float __high2float(__nv_bfloat162 v) { return __bfloat162float(v.y); }
