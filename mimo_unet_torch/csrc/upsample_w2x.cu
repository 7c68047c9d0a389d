// W half of the bilinear x2 align-corners upsample, channels-last bf16:
// [rows, W2, C] -> [rows, 2*W2, C].
//
// Replaces the forward of mimo_unet_tpu/ops/pallas/ct_resize.py:209
// upsample_w2x_ct (_w2x_fwd_call :222), which contracts each row with the
// bf16-rounded [W2, 2*W2] interpolation matrix at f32 accumulation.  Only
// two entries of each matrix column are nonzero, so here every output is
//   bf16(x[lo_j] * w0_j + x[lo_j + 1] * w1_j)
// from per-column tables (lo, w0, w1) that the wrapper builds once: the
// products of two bf16 values are exact in f32, so the f32 sum, rounded
// once, is bitwise the TPU kernel's dot.  Bound on the H100 by device-memory
// bytes (read x once, write twice its size); one grid-stride pass, each
// thread one output element, consecutive threads on consecutive channels.
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
