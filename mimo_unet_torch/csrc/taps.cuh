// The transpose of the bilinear x2 align-corners lerp along W, shared by
// K4b (upsample_w2x.cu) and the W pass of K13's backward (upsample2x.cu):
// half column K reads full columns 2K-2+u, u = 0 .. TAPS-1, with weights
// ww[K, u] (the bf16 interpolation matrix's entries, 0 where a tap falls
// outside the row), summed in f32 in tap order from +0 with __fmul_rn /
// __fadd_rn (nvcc contracts nothing into an FMA) and rounded once.  A tap
// outside the row reads the row's edge column with its weight 0, as the
// plain versions do.
#pragma once

#include "common.cuh"

constexpr int TAPS = 5;  // full columns (rows) that reach one half column (row)

// half column K's weights and its taps' full columns (of a row of w),
// clamped into the row
__device__ __forceinline__ void w_taps(const float* __restrict__ ww, int K, int w,
                                       float wk[TAPS], int col[TAPS]) {
#pragma unroll
  for (int u = 0; u < TAPS; ++u) {
    wk[u] = ww[K * TAPS + u];
    col[u] = min(max(2 * K - 2 + u, 0), w - 1);
  }
}

// v + g * wt, the sum's next tap
__device__ __forceinline__ float tap_add(float v, float g, float wt) {
  return __fadd_rn(v, __fmul_rn(g, wt));
}

// 16-byte units of a staged full row: the full columns of te half-row
// elements and their halo, from any element offset
__host__ __device__ __forceinline__ int full_units(int te, int c) {
  return (2 * te + 7 * c + 15) / 8 + 2;
}
