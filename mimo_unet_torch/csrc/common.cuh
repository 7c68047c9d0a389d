// Shared helpers of the MIMO U-Net kernels (plain C interface, sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16_rn(v); }

// eight bf16 packed in 16 bytes -> eight floats (bf16 is the high half of
// an f32, so the conversion is a shift or a mask)
__device__ __forceinline__ void unpack8(uint4 v, float* f) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// grid-stride bound for elementwise passes: enough blocks to fill 132 SMs
static inline unsigned int elementwise_blocks(int64_t work, int threads) {
  int64_t b = (work + threads - 1) / threads;
  const int64_t cap = 132 * 16;
  return (unsigned int)(b < cap ? (b > 0 ? b : 1) : cap);
}
