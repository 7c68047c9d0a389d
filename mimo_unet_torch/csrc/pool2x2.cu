// 2x2 / stride-2 max pool of a channels-last bf16 tensor and its backward:
// [N, H, W, C] -> [N, H/2, W/2, C].
//
// Replaces mimo_unet_tpu/ops/pallas/ct_elem.py:282 max_pool2x2_ct (its
// forward), :336 _pool_bwd_call (its backward) and :411
// max_pool2x2_skip_ct (the same backward with the skip branch's cotangent
// added in the pass).  Semantics of those kernels:
//   forward   y = max of the window (a row-pair max, then a column-pair
//             max; exact, so bitwise the TPU kernel's f32 max cast back)
//   backward  gx = bf16( where(x == up(y), up(g), 0) [+ g_skip] )
// computed in f32 and rounded once.  Under ties every tied element of a
// window gets the window's gradient, the all-zero windows after a ReLU
// included (F.max_pool2d's backward gives it to one element).
//
// Bound on the H100 by device-memory bytes: the forward reads x once and
// writes a quarter of it; the backward reads g, x, y (and g_skip) and
// writes gx, each once.  Design: one block per output row (grid.x, so no
// 64-bit division per element) whose threads loop over the row,
// consecutive threads on consecutive channels, so a warp reads
// contiguous bytes of each input pixel.  With C even each
// thread moves a bf16 pair (4-byte accesses; every pixel offset is even);
// with C odd (21 at the flagship's full resolution) one channel.  The
// backward re-reads each pooled element once per window element: those
// four reads hit the cache.  Nothing here needs H or W to be a multiple
// of anything but 2.
#include "common.cuh"

namespace {

__device__ __forceinline__ bf16 vmax(bf16 a, bf16 b) { return __hmax_nan(a, b); }
__device__ __forceinline__ __nv_bfloat162 vmax(__nv_bfloat162 a, __nv_bfloat162 b) {
  return __hmax2_nan(a, b);
}

// T = bf16 or __nv_bfloat162; c counts T units per pixel.  blockIdx.x is
// the output row img*h2 + i, whose input rows are 2*(img*h2 + i) and the
// next one (h is even).
template <typename T>
__global__ void pool2x2_kernel(const T* __restrict__ x, T* __restrict__ y,
                               int w2, int c) {
  const int len = w2 * c;
  const int64_t in_row = (int64_t)2 * len;  // one input row: w = 2*w2 pixels
  const T* x0 = x + (int64_t)blockIdx.x * 2 * in_row;
  T* out = y + (int64_t)blockIdx.x * len;
  for (int t = blockIdx.y * blockDim.x + threadIdx.x; t < len;
       t += gridDim.y * blockDim.x) {
    const int j = t / c;
    const int i0 = t + j * c;  // (2j)*c + ch
    out[t] = vmax(vmax(x0[i0], x0[i0 + in_row]),
                  vmax(x0[i0 + c], x0[i0 + in_row + c]));
  }
}

// blockIdx.x is the input row img*h + r; its pooled row is blockIdx.x / 2.
// A thread handles V channels (V = 2: a channel pair) of one pixel.
template <int V, bool SKIP>
__global__ void pool2x2_bwd_kernel(const bf16* __restrict__ g,
                                   const bf16* __restrict__ x,
                                   const bf16* __restrict__ y,
                                   const bf16* __restrict__ gs,
                                   bf16* __restrict__ gx, int w, int c) {
  const int cv = c / V;
  const int units = w * cv;
  const int64_t row = (int64_t)blockIdx.x * w * c;
  const int64_t prow = (int64_t)(blockIdx.x >> 1) * (w >> 1) * c;
  for (int t = blockIdx.y * blockDim.x + threadIdx.x; t < units;
       t += gridDim.y * blockDim.x) {
    const int q = t / cv;
    const int ch = (t - q * cv) * V;
    const int64_t e = row + (int64_t)q * c + ch;
    const int64_t p = prow + (int64_t)(q >> 1) * c + ch;
    float xv[V], yv[V], gv[V], sv[V] = {}, v[V];
    load_bf16<V>(x + e, xv);
    load_bf16<V>(y + p, yv);
    load_bf16<V>(g + p, gv);
    if (SKIP) load_bf16<V>(gs + e, sv);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      v[i] = xv[i] == yv[i] ? gv[i] : 0.f;
      if (SKIP) v[i] = __fadd_rn(v[i], sv[i]);
    }
    store_bf16<V>(gx + e, v);
  }
}

}  // namespace

extern "C" int mimo_pool2x2(const void* x, void* y, int64_t n, int64_t h,
                            int64_t w, int64_t c, void* stream) {
  if (n <= 0 || h < 2 || h % 2 || w < 2 || w % 2 || c <= 0)
    return (int)cudaErrorInvalidValue;
  const bool pairs = c % 2 == 0;
  const int64_t cu = pairs ? c / 2 : c;
  dim3 grid;
  if (!row_grid(n * (h / 2), (w / 2) * cu, &grid)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (pairs) {
    pool2x2_kernel<<<grid, ROW_THREADS, 0, s>>>((const __nv_bfloat162*)x,
                                            (__nv_bfloat162*)y, (int)(w / 2), (int)cu);
  } else {
    pool2x2_kernel<<<grid, ROW_THREADS, 0, s>>>((const bf16*)x, (bf16*)y, (int)(w / 2),
                                            (int)cu);
  }
  return (int)cudaGetLastError();
}

// g, y [N, H/2, W/2, C]; x, gs (may be null), gx [N, H, W, C]
extern "C" int mimo_pool2x2_bwd(const void* g, const void* x, const void* y,
                                const void* gs, void* gx, int64_t n, int64_t h,
                                int64_t w, int64_t c, void* stream) {
  if (n <= 0 || h < 2 || h % 2 || w < 2 || w % 2 || c <= 0)
    return (int)cudaErrorInvalidValue;
  const bool pairs = c % 2 == 0;
  const int64_t cu = pairs ? c / 2 : c;
  dim3 grid;
  if (!row_grid(n * h, w * cu, &grid)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bf16 *gb = (const bf16*)g, *xb = (const bf16*)x, *yb = (const bf16*)y,
             *sb = (const bf16*)gs;
  bf16* out = (bf16*)gx;
  if (pairs && gs) {
    pool2x2_bwd_kernel<2, true><<<grid, ROW_THREADS, 0, s>>>(gb, xb, yb, sb, out, (int)w, (int)c);
  } else if (pairs) {
    pool2x2_bwd_kernel<2, false><<<grid, ROW_THREADS, 0, s>>>(gb, xb, yb, sb, out, (int)w, (int)c);
  } else if (gs) {
    pool2x2_bwd_kernel<1, true><<<grid, ROW_THREADS, 0, s>>>(gb, xb, yb, sb, out, (int)w, (int)c);
  } else {
    pool2x2_bwd_kernel<1, false><<<grid, ROW_THREADS, 0, s>>>(gb, xb, yb, sb, out, (int)w, (int)c);
  }
  return (int)cudaGetLastError();
}
