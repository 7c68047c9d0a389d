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

// V channels at p (V = 2: an aligned bf16 pair) to and from floats
template <int V>
__device__ __forceinline__ void load_bf16(const bf16* p, float* f) {
  if constexpr (V == 2) {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
    f[0] = __low2float(v);
    f[1] = __high2float(v);
  } else {
    f[0] = bf2f(*p);
  }
}

template <int V>
__device__ __forceinline__ void store_bf16(bf16* p, const float* f) {
  if constexpr (V == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(f[0], f[1]);
  } else {
    *p = f2bf(f[0]);
  }
}

// grid-stride bound for elementwise passes: enough blocks to fill 132 SMs
static inline unsigned int elementwise_blocks(int64_t work, int threads) {
  int64_t b = (work + threads - 1) / threads;
  const int64_t cap = 132 * 16;
  return (unsigned int)(b < cap ? (b > 0 ? b : 1) : cap);
}

// threads of a row-pass block
constexpr int ROW_THREADS = 256;

// grid of a pass over rows of len elements: rows x chunks of a row; a row
// takes one block (its threads loop over it) once there are rows enough
// to fill the card, as short-lived blocks cost more to schedule than the
// work they do.  False when the shape is out of the grid's range.
static inline bool row_grid(int64_t rows, int64_t len, dim3* grid) {
  if (rows <= 0 || rows > 0x7fffffff || len <= 0 || len > 0x3fffffff) return false;
  const int64_t chunks = (len + ROW_THREADS - 1) / ROW_THREADS;
  const int64_t want = (132 * 16 + rows - 1) / rows;
  *grid = dim3((unsigned)rows, (unsigned)(want < chunks ? want : chunks));
  return true;
}
