// A CPU stand-in for cuda_bf16.h (see cuda_runtime.h beside it): bfloat16
// storage, a pair, and the conversions, rounding to nearest even like the card
// and like torch's .to(torch.bfloat16) (no NaNs occur in the tests).
#pragma once
#include <cstdint>
#include <cstring>

struct __nv_bfloat16 {
  uint16_t bits;
};

inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return __nv_bfloat16{(uint16_t)(u >> 16)};
}

inline float __bfloat162float(__nv_bfloat16 b) {
  const uint32_t u = (uint32_t)b.bits << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

struct __nv_bfloat162 {
  __nv_bfloat16 x, y;
};

inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16(a), __float2bfloat16(b)};
}

inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
