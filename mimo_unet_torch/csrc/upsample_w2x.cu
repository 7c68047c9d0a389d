// W half of the bilinear x2 align-corners upsample, channels-last bf16:
// [rows, W2, C] -> [rows, 2*W2, C], and its transpose.
//
// mimo_upsample_w2x replaces the forward of
// mimo_unet_tpu/ops/pallas/ct_resize.py:209 upsample_w2x_ct (_w2x_fwd_call
// :222), which contracts each row with the bf16-rounded [W2, 2*W2]
// interpolation matrix at f32 accumulation.  Only two entries of each
// matrix column are nonzero, so here every output is
//   bf16(x[lo_j] * w0_j + x[lo_j + 1] * w1_j)
// from per-column tables (lo, w0, w1) that the wrapper builds once: the
// products of two bf16 values are exact in f32, so the f32 sum, rounded
// once, is bitwise the TPU kernel's dot.  One grid-stride pass, each
// thread one output element, consecutive threads on consecutive channels.
//
// mimo_upsample_w2x_bwd replaces its VJP, ct_resize.py:254 _w2x_bwd_call
// (pallas_call :269; _w2x_bwd_rule :366): the cotangent row contracted
// with the same bf16 matrix.  Column K of a row takes full columns
// 2K-2 .. 2K+2 (the only nonzero entries of its matrix row), summed in
// f32 in that order with __fmul_rn / __fadd_rn and rounded once:
//   dx(K) = bf16(sum_u ww[K, u] * g(2K-2+u)), ww [W2, 5] the bf16 matrix
// entries (0 outside the image): the W pass of upsample2x.cu's backward.
// One block per row (common.cuh row_grid), channel pairs where C is even.
//
// Both are bound on the H100 by device-memory bytes (read one side once,
// write the other, twice its size or half).
#include "common.cuh"

namespace {

__global__ void upsample_w2x_kernel(const bf16* __restrict__ x,
                                    const int* __restrict__ lo,
                                    const float* __restrict__ w0,
                                    const float* __restrict__ w1,
                                    bf16* __restrict__ out, int64_t n_out,
                                    int64_t w2, int64_t c) {
  const int64_t wo = 2 * w2;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n_out;
       e += stride) {
    const int64_t pix = e / c;
    const int64_t ch = e - pix * c;
    const int64_t row = pix / wo;
    const int j = (int)(pix - row * wo);
    const int64_t src = (row * w2 + lo[j]) * c + ch;
    const float a = bf2f(x[src]);
    const float b = bf2f(x[src + c]);
    // explicit rounding: no contraction into an FMA, as the plain version
    out[e] = f2bf(__fadd_rn(__fmul_rn(a, w0[j]), __fmul_rn(b, w1[j])));
  }
}

constexpr int TAPS = 5;  // full columns that reach one half column

// blockIdx.x = row; the row's w2 * c outputs, V channels a thread at a time
template <int V>
__global__ void upsample_w2x_bwd_kernel(const bf16* __restrict__ g,
                                        const float* __restrict__ ww,
                                        bf16* __restrict__ dx, int w2, int c) {
  const int w = 2 * w2;
  const bf16* gr = g + (int64_t)blockIdx.x * w * c;
  bf16* out = dx + (int64_t)blockIdx.x * w2 * c;
  const int cv = c / V;
  const int units = w2 * cv;
  for (int e = blockIdx.y * blockDim.x + threadIdx.x; e < units;
       e += gridDim.y * blockDim.x) {
    const int K = e / cv;
    const int ch = (e - K * cv) * V;
    float v[V] = {};
#pragma unroll
    for (int u = 0; u < TAPS; ++u) {
      const int j = 2 * K - 2 + u;
      if (j < 0 || j >= w) continue;  // tap weight 0
      float gv[V];
      load_bf16<V>(gr + (int64_t)j * c + ch, gv);
      const float wu = ww[K * TAPS + u];
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = __fadd_rn(v[i], __fmul_rn(gv[i], wu));
    }
    store_bf16<V>(out + (int64_t)K * c + ch, v);
  }
}

}  // namespace

extern "C" int mimo_upsample_w2x(const void* x, const void* lo, const void* w0,
                                 const void* w1, void* out, int64_t rows,
                                 int64_t w2, int64_t c, void* stream) {
  if (rows <= 0 || w2 < 2 || c <= 0) return (int)cudaErrorInvalidValue;
  const int64_t n_out = rows * 2 * w2 * c;
  const int threads = 256;
  upsample_w2x_kernel<<<elementwise_blocks(n_out, threads), threads, 0,
                        (cudaStream_t)stream>>>(
      (const bf16*)x, (const int*)lo, (const float*)w0, (const float*)w1,
      (bf16*)out, n_out, w2, c);
  return (int)cudaGetLastError();
}

// g [rows, 2*W2, C] -> dx [rows, W2, C]; ww [W2, 5]
extern "C" int mimo_upsample_w2x_bwd(const void* g, const void* ww, void* dx,
                                     int64_t rows, int64_t w2, int64_t c,
                                     void* stream) {
  const int v = c % 2 == 0 ? 2 : 1;
  dim3 grid;
  if (rows <= 0 || w2 < 2 || c <= 0 || !row_grid(rows, w2 * c / v, &grid) ||
      2 * w2 * c > 0x3fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (v == 2) {
    upsample_w2x_bwd_kernel<2><<<grid, ROW_THREADS, 0, s>>>(
        (const bf16*)g, (const float*)ww, (bf16*)dx, (int)w2, (int)c);
  } else {
    upsample_w2x_bwd_kernel<1><<<grid, ROW_THREADS, 0, s>>>(
        (const bf16*)g, (const float*)ww, (bf16*)dx, (int)w2, (int)c);
  }
  return (int)cudaGetLastError();
}
