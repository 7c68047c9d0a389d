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

// ---- staged tiles (the tensor-core conv kernels)

// row stride (elements) of a staged tile with c (a multiple of 8) channels:
// an odd number of 16-byte units, so ldmatrix's eight rows miss each other
__host__ __device__ __forceinline__ int stride8(int c) { return 8 * ((c / 8) | 1); }

// bytes of the raw buffer of one run of px pixels of c bf16 channels copied
// in 16-byte units from any element offset
__host__ __device__ __forceinline__ int run_bytes(int px, int c) {
  return 16 * ((px * c * 2 + 15) / 16 + 1);
}

__host__ __device__ __forceinline__ int align16(int b) { return (b + 15) & ~15; }

// reflect padding by one: index -1 reads 1, index n reads n - 2
__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

// a * wa + b * wb in f32, each product and the sum rounded on its own (no
// FMA contraction): the align-corners lerps of the upsample kernels
__device__ __forceinline__ float lerp2(float a, float wa, float b, float wb) {
  return __fadd_rn(__fmul_rn(a, wa), __fmul_rn(b, wb));
}

// eight values (bf16-exact) as one 16-byte shared-memory store
__device__ __forceinline__ void st8(bf16* dst, const float v[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = u;
}

// up to eight bf16 (bit copies) from src at any 2-byte alignment, zeros
// from n on, as one 16-byte unit
__device__ __forceinline__ uint4 ld8(const bf16* src, int n) {
  uint32_t w[4];
  if (n >= 8 && ((uintptr_t)src & 3) == 0) {
    const uint32_t* q = reinterpret_cast<const uint32_t*>(src);
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = q[i];
  } else {
    const uint16_t* q = reinterpret_cast<const uint16_t*>(src);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (2 * i < n ? (uint32_t)q[2 * i] : 0u) |
             (2 * i + 1 < n ? (uint32_t)q[2 * i + 1] << 16 : 0u);
  }
  uint4 u;
  u.x = w[0];
  u.y = w[1];
  u.z = w[2];
  u.w = w[3];
  return u;
}
