// Bilinear x2 upsample with align_corners=True of a channels-last bf16
// tensor, and its transpose: [N, H2, W2, C] <-> [N, 2*H2, 2*W2, C]; and the
// transpose of its H lerp alone: [N, 2*H2, W, C] -> [N, H2, W, C].
//
// Replaces mimo_unet_tpu/ops/pallas/ct_resize.py:54 upsample2x_ct: its
// forward _up2_fwd_call (:59) and its backward _up2_bwd_call (:124), with
// their rounding points; and ct_resize.py:295 lerp_h2x_transpose_ct
// (pallas_call :345), the backward of the x2-half train decoder's in-kernel
// H lerp.  The wrapper (kernels/upsample2x.py) builds the small per-row and
// per-column tables once:
//   W taps   lo_w, w0, w1 [W]: the two nonzero entries of column q of the
//            [W2, W] interpolation matrix, rounded to bf16 (the TPU kernel
//            contracts with the bf16 matrix);
//   H lerp   lo_h [H], fa = 1 - f, fb = f in f32 from the TPU kernel's
//            integer row arithmetic, f = float32(r*(H2-1) - lo*(H-1)) *
//            float32(1/(H-1)) (XLA compiles its division by the constant
//            H-1 into that multiply);
//   backward taps: half row R (column K) reads full rows (columns)
//            2R-2 .. 2R+2 with the f32 H weights (the bf16 matrix
//            entries), 0 where a tap falls outside the image.
// Forward, W first:
//   s(row, q) = bf16(x[row, lo_w] * w0 + x[row, lo_w + 1] * w1)
// (two exact products, one rounding: bitwise the TPU kernel's dot), then
//   y(r, q)   = bf16(s(lo_h, q) * fa + s(lo_h + 1, q) * fb).
// Backward, H transpose first, each half-res value a sum in tap order:
//   acc(R, j) = bf16(sum_t wh[R, t] * g(2R-2+t, j))
//   dx(R, K)  = bf16(sum_u ww[K, u] * acc(R, 2K-2+u)).
// The H transpose alone (mimo_lerp_h2x_transpose) is acc, written out; the
// W transpose alone is mimo_upsample_w2x_bwd (upsample_w2x.cu), so the two
// in turn give this backward bit for bit.
// Products and sums use __fmul_rn / __fadd_rn so that nvcc contracts
// nothing into an FMA: the plain version rounds at the same points.
//
// Bound on the H100 by device-memory bytes (the small input read once,
// the 4x larger output written once, or the reverse).  Design: one block
// per output row (grid.x, no 64-bit division per element) whose threads
// loop over the row, consecutive threads on consecutive channels.  The
// forward reads four input values per output, the backward 25 cotangent
// values (5 taps x 5 taps) per output, the H transpose 5: those repeat
// across neighbouring threads and rows and hit the cache.  With C even a
// thread moves a channel pair (4-byte accesses).  Any H2, W2 >= 2.
#include "common.cuh"

namespace {

constexpr int TAPS = 5;

__device__ __forceinline__ float lerp2(float a, float wa, float b, float wb) {
  return __fadd_rn(__fmul_rn(a, wa), __fmul_rn(b, wb));
}

__device__ __forceinline__ float round_bf16(float v) { return bf2f(f2bf(v)); }

// acc = sum over the taps t inside the image of hw[t] * g(2R-2+t, col), in
// tap order, f32: half row R's share of full column ``col`` (gi: the
// image's first full row, off: the column's element offset in a row)
template <int V>
__device__ __forceinline__ void h_transpose(const bf16* __restrict__ gi,
                                            const float hw[TAPS], int R, int h,
                                            int64_t full_row, int64_t off,
                                            float acc[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
#pragma unroll
  for (int t = 0; t < TAPS; ++t) {
    const int r = 2 * R - 2 + t;
    if (r < 0 || r >= h) continue;  // tap weight 0
    float gv[V];
    load_bf16<V>(gi + r * full_row + off, gv);
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(hw[t], gv[i]));
  }
}

// blockIdx.x = img*h + r: output row r of image img; a thread handles V
// channels of one output pixel at a time
template <int V>
__global__ void up2_fwd_kernel(const bf16* __restrict__ x,
                               const int* __restrict__ lo_w,
                               const float* __restrict__ w0,
                               const float* __restrict__ w1,
                               const int* __restrict__ lo_h,
                               const float* __restrict__ fa,
                               const float* __restrict__ fb,
                               bf16* __restrict__ y, int h, int w2, int c) {
  const int h2 = h / 2;
  const int img = blockIdx.x / h;
  const int r = blockIdx.x - img * h;
  const int64_t in_row = (int64_t)w2 * c;
  const bf16* x0 = x + ((int64_t)img * h2 + lo_h[r]) * in_row;
  const bf16* x1 = x0 + in_row;
  const float a = fa[r], b = fb[r];
  const int cv = c / V;
  const int units = 2 * w2 * cv;
  bf16* out = y + (int64_t)blockIdx.x * 2 * in_row;
  for (int t = blockIdx.y * blockDim.x + threadIdx.x; t < units;
       t += gridDim.y * blockDim.x) {
    const int q = t / cv;
    const int ch = (t - q * cv) * V;
    const int k = lo_w[q] * c + ch;
    const float u0 = w0[q], u1 = w1[q];
    float p0[V], p1[V], p2[V], p3[V], o[V];
    load_bf16<V>(x0 + k, p0);
    load_bf16<V>(x0 + k + c, p1);
    load_bf16<V>(x1 + k, p2);
    load_bf16<V>(x1 + k + c, p3);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float s0 = round_bf16(lerp2(p0[i], u0, p1[i], u1));
      const float s1 = round_bf16(lerp2(p2[i], u0, p3[i], u1));
      o[i] = lerp2(s0, a, s1, b);
    }
    store_bf16<V>(out + (int64_t)q * c + ch, o);
  }
}

// blockIdx.x = img*h2 + R: half-res row R of image img
template <int V>
__global__ void up2_bwd_kernel(const bf16* __restrict__ g,
                               const float* __restrict__ wh,
                               const float* __restrict__ ww,
                               bf16* __restrict__ dx, int h2, int w2, int c) {
  const int h = 2 * h2, w = 2 * w2;
  const int img = blockIdx.x / h2;
  const int R = blockIdx.x - img * h2;
  const int64_t full_row = (int64_t)w * c;
  const bf16* gi = g + (int64_t)img * h * full_row;
  float hw[TAPS];
#pragma unroll
  for (int t = 0; t < TAPS; ++t) hw[t] = wh[R * TAPS + t];
  const int cv = c / V;
  const int units = w2 * cv;
  bf16* out = dx + (int64_t)blockIdx.x * w2 * c;
  for (int e = blockIdx.y * blockDim.x + threadIdx.x; e < units;
       e += gridDim.y * blockDim.x) {
    const int K = e / cv;
    const int ch = (e - K * cv) * V;
    float v[V] = {};
#pragma unroll
    for (int u = 0; u < TAPS; ++u) {
      const int j = 2 * K - 2 + u;
      if (j < 0 || j >= w) continue;  // tap weight 0
      float acc[V];
      h_transpose<V>(gi, hw, R, h, full_row, (int64_t)j * c + ch, acc);
      const float wu = ww[K * TAPS + u];
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = __fadd_rn(v[i], __fmul_rn(round_bf16(acc[i]), wu));
    }
    store_bf16<V>(out + (int64_t)K * c + ch, v);
  }
}

// blockIdx.x = img*h2 + R: half row R of image img, every full column
template <int V>
__global__ void lerp_h2x_t_kernel(const bf16* __restrict__ g,
                                  const float* __restrict__ wh,
                                  bf16* __restrict__ dx, int h2, int w, int c) {
  const int h = 2 * h2;
  const int img = blockIdx.x / h2;
  const int R = blockIdx.x - img * h2;
  const int64_t full_row = (int64_t)w * c;
  const bf16* gi = g + (int64_t)img * h * full_row;
  float hw[TAPS];
#pragma unroll
  for (int t = 0; t < TAPS; ++t) hw[t] = wh[R * TAPS + t];
  const int units = w * c / V;
  bf16* out = dx + (int64_t)blockIdx.x * full_row;
  for (int e = blockIdx.y * blockDim.x + threadIdx.x; e < units;
       e += gridDim.y * blockDim.x) {
    float acc[V];
    h_transpose<V>(gi, hw, R, h, full_row, (int64_t)e * V, acc);
    store_bf16<V>(out + (int64_t)e * V, acc);
  }
}

}  // namespace

// x [N, H2, W2, C] -> y [N, 2*H2, 2*W2, C]; tables as above
extern "C" int mimo_upsample2x(const void* x, const void* lo_w, const void* w0,
                               const void* w1, const void* lo_h, const void* fa,
                               const void* fb, void* y, int64_t n, int64_t h2,
                               int64_t w2, int64_t c, void* stream) {
  const int v = c % 2 == 0 ? 2 : 1;
  dim3 grid;
  if (n <= 0 || h2 < 2 || w2 < 2 || c <= 0 || !row_grid(n * 2 * h2, 2 * w2 * c / v, &grid))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (v == 2) {
    up2_fwd_kernel<2><<<grid, ROW_THREADS, 0, s>>>(
        (const bf16*)x, (const int*)lo_w, (const float*)w0, (const float*)w1,
        (const int*)lo_h, (const float*)fa, (const float*)fb, (bf16*)y, (int)(2 * h2),
        (int)w2, (int)c);
  } else {
    up2_fwd_kernel<1><<<grid, ROW_THREADS, 0, s>>>(
        (const bf16*)x, (const int*)lo_w, (const float*)w0, (const float*)w1,
        (const int*)lo_h, (const float*)fa, (const float*)fb, (bf16*)y, (int)(2 * h2),
        (int)w2, (int)c);
  }
  return (int)cudaGetLastError();
}

// g [N, 2*H2, 2*W2, C] -> dx [N, H2, W2, C]; wh [H2, 5], ww [W2, 5]
extern "C" int mimo_upsample2x_bwd(const void* g, const void* wh, const void* ww,
                                   void* dx, int64_t n, int64_t h2, int64_t w2,
                                   int64_t c, void* stream) {
  const int v = c % 2 == 0 ? 2 : 1;
  dim3 grid;
  if (n <= 0 || h2 < 2 || w2 < 2 || c <= 0 || !row_grid(n * h2, w2 * c / v, &grid) ||
      2 * w2 * c > 0x3fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (v == 2) {
    up2_bwd_kernel<2><<<grid, ROW_THREADS, 0, s>>>((const bf16*)g, (const float*)wh,
                                               (const float*)ww, (bf16*)dx, (int)h2,
                                               (int)w2, (int)c);
  } else {
    up2_bwd_kernel<1><<<grid, ROW_THREADS, 0, s>>>((const bf16*)g, (const float*)wh,
                                               (const float*)ww, (bf16*)dx, (int)h2,
                                               (int)w2, (int)c);
  }
  return (int)cudaGetLastError();
}

// g [N, 2*H2, W, C] -> dx [N, H2, W, C]; wh [H2, 5]
extern "C" int mimo_lerp_h2x_transpose(const void* g, const void* wh, void* dx,
                                       int64_t n, int64_t h2, int64_t w,
                                       int64_t c, void* stream) {
  const int v = c % 2 == 0 ? 2 : 1;
  dim3 grid;
  if (n <= 0 || h2 < 2 || w <= 0 || c <= 0 || !row_grid(n * h2, w * c / v, &grid) ||
      w * c > 0x3fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (v == 2) {
    lerp_h2x_t_kernel<2><<<grid, ROW_THREADS, 0, s>>>((const bf16*)g, (const float*)wh,
                                                      (bf16*)dx, (int)h2, (int)w, (int)c);
  } else {
    lerp_h2x_t_kernel<1><<<grid, ROW_THREADS, 0, s>>>((const bf16*)g, (const float*)wh,
                                                      (bf16*)dx, (int)h2, (int)w, (int)c);
  }
  return (int)cudaGetLastError();
}
