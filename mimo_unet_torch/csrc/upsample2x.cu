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
// Bound on the H100 by device-memory bytes: the small input read once, the
// 4x larger output written once, or the reverse.  The two K13 kernels
// stage what a block reads in shared memory and compute each intermediate
// once:
//   forward   a block owns a band of UP_BAND output rows and a tile of at
//             most UP_TILE elements of the contiguous output row (cut in
//             elements, so any C fits; a multiple of 8).  It copies the
//             input rows the band reads, over the tile's columns and their
//             halo, into shared memory once by 16-byte cp.async, W-lerps
//             each of them once into a bf16 row s (the thread of an
//             8-element chunk finds its columns' taps once, for every
//             row), then writes the band's output rows from the two s rows
//             each reads, 8 elements a thread as 16-byte stores.
//   backward  a block owns a band of BK_BAND half rows and a tile of at
//             most BK_TILE elements of the half row.  It copies the full
//             rows the band reads (2 * BK_BAND + 3, each from device memory
//             once), over the tile's full columns and their halo, into
//             shared memory by 16-byte cp.async; computes acc(R, j) once per
//             half row and full column, 8 elements a thread from 16-byte
//             reads of the taps' rows (the (half row, chunk) pairs spread
//             over all threads), into shared memory as bf16; then dx(R, K)
//             from it, consecutive threads on consecutive elements, each
//             thread finding its element's taps and weights once for all
//             the band's half rows.
// An unaligned pointer, a row that does not start on 16 bytes (odd C) and
// a tile's ragged end take scalar loads and stores in the same kernels,
// with the same arithmetic.  K14 (lerp_h2x_t_kernel) keeps one block a
// half row, a thread a channel pair.  Any H2, W2 >= 2.
#include "common.cuh"
#include "ptx.cuh"
#include "stage.cuh"
#include "taps.cuh"

namespace {

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

constexpr int UP_THREADS = 256;
constexpr int UP_BAND = 16;                  // output rows a forward block
constexpr int UP_TILE = 8 * UP_THREADS;      // output-row elements a forward block at most
constexpr int UP_ROWS = UP_BAND / 2 + 3;     // input rows a forward band reads at most
constexpr int BK_BAND = 4;                   // half rows a backward block
constexpr int BK_TILE = 4 * UP_THREADS;      // half-row elements a backward block at most
constexpr int BK_ROWS = 2 * BK_BAND + 3;     // full rows a backward band reads at most
constexpr int SMEM_MAX = 232448;             // dynamic shared memory a block can have

// 16-byte units of a forward block's staged input row: the input columns
// of te output-row elements and their halo, from any element offset
__host__ __device__ __forceinline__ int fwd_in_units(int te, int c) {
  return (te / 2 + 4 * c + 7) / 8 + 2;
}

size_t fwd_smem(int te, int c) {
  return (size_t)UP_ROWS * (16 * (size_t)fwd_in_units(te, c) + 2 * (size_t)te);
}

size_t bwd_smem(int te, int c) {
  return (size_t)(BK_ROWS + BK_BAND) * 16 * (size_t)full_units(te, c);  // rows, acc rows
}

// eight bf16 from shared memory at any 2-byte alignment
__device__ __forceinline__ void load8(const bf16* p, float f[8]) {
  unpack8(((uintptr_t)p & 15) == 0 ? *reinterpret_cast<const uint4*>(p) : ld8(p, 8), f);
}

// block UP_THREADS: output rows [r0, r0 + UP_BAND) of image img, elements
// [e0, e0 + te) of each (blockIdx.x = (img * bands + band) * tiles + tile).
// vec: x and y are 16-byte aligned.
__global__ void __launch_bounds__(UP_THREADS) up2_fwd_kernel(
    const bf16* __restrict__ x, const int* __restrict__ lo_w,
    const float* __restrict__ w0, const float* __restrict__ w1,
    const int* __restrict__ lo_h, const float* __restrict__ fa,
    const float* __restrict__ fb, bf16* __restrict__ y, int h, int w2, int c, int te,
    int tiles, int bands, int64_t xtot, int vec) {
  extern __shared__ uint4 up_smem[];
  const int tid = threadIdx.x;
  const int h2 = h / 2, rowlen = 2 * w2 * c, inlen = w2 * c;
  const int tile = blockIdx.x % tiles, band = blockIdx.x / tiles % bands;
  const int img = blockIdx.x / tiles / bands;
  const int r0 = band * UP_BAND, r1 = min(r0 + UP_BAND, h);
  const int e0 = tile * te, e1 = min(e0 + te, rowlen);
  const int j0 = lo_h[r0], j1 = lo_h[r1 - 1] + 2;                   // input rows
  const int i0 = lo_w[e0 / c] * c, i1 = (lo_w[(e1 - 1) / c] + 2) * c;  // their elements
  const int iu = 8 * fwd_in_units(te, c);
  bf16* raw = reinterpret_cast<bf16*>(up_smem);  // UP_ROWS rows of iu elements
  bf16* s = raw + UP_ROWS * iu;                  // UP_ROWS rows of te
  const int64_t xi = (int64_t)img * h2 * inlen;
  for (int j = j0; j < j1; ++j) {
    const int64_t off = xi + (int64_t)j * inlen;
    stage_units(raw + (j - j0) * iu, x, off + i0, off + i1, xtot, vec, tid, UP_THREADS);
  }
  cp_async_commit();

  // this thread's chunk: output-row elements e .. e + 7, each one's two
  // input elements (offset from i0) and weights
  const int e = e0 + 8 * tid;
  const bool mine = e < e1;
  int kk[8];
  float u0[8], u1[8];
  {
    int q = e / c, ch = e - q * c;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const bool in = e + i < e1;
      kk[i] = in ? lo_w[q] * c + ch - i0 : 0;
      u0[i] = in ? w0[q] : 0.f;
      u1[i] = in ? w1[q] : 0.f;
      if (++ch == c) {
        ch = 0;
        ++q;
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();
  // s(row, .) = bf16(x[row, lo] * w0 + x[row, lo + 1] * w1); input row j's
  // element i0 sits at (sh0 + (j - j0) * inlen) % 8 of its staged row
  const int sh0 = (int)((xi + (int64_t)j0 * inlen + i0) & 7), in7 = inlen & 7;
  if (mine)
    for (int j = 0; j < j1 - j0; ++j) {
      const bf16* rj = raw + j * iu + ((sh0 + j * in7) & 7);
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = lerp2(bf2f(rj[kk[i]]), u0[i], bf2f(rj[kk[i] + c]), u1[i]);
      st8(s + j * te + 8 * tid, v);
    }
  __syncthreads();
  if (!mine) return;
  for (int r = r0; r < r1; ++r) {  // y(r, .) = bf16(s(lo) * fa + s(lo + 1) * fb)
    const bf16* sr = s + (lo_h[r] - j0) * te + 8 * tid;
    const float a = fa[r], b = fb[r];
    float p[8], q[8], o[8];
    unpack8(*reinterpret_cast<const uint4*>(sr), p);
    unpack8(*reinterpret_cast<const uint4*>(sr + te), q);
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = lerp2(p[i], a, q[i], b);
    const int64_t row = ((int64_t)img * h + r) * rowlen;
    store8(y, row + e, row + e1, o, vec);
  }
}

// block UP_THREADS: half rows [R0, R0 + BK_BAND) of image img, elements
// [d0, d0 + te) of each (blockIdx.x = (img * bands + band) * tiles + tile).
// vec: g is 16-byte aligned.
__global__ void __launch_bounds__(UP_THREADS) up2_bwd_kernel(
    const bf16* __restrict__ g, const float* __restrict__ wh,
    const float* __restrict__ ww, bf16* __restrict__ dx, int h2, int w2, int c, int te,
    int tiles, int bands, int64_t gtot, int vec) {
  extern __shared__ uint4 up_smem[];
  const int tid = threadIdx.x;
  const int h = 2 * h2, w = 2 * w2, rowlen = w * c, halflen = w2 * c;
  const int tile = blockIdx.x % tiles, band = blockIdx.x / tiles % bands;
  const int img = blockIdx.x / tiles / bands;
  const int R0 = band * BK_BAND, nr = min(BK_BAND, h2 - R0);
  const int r0 = max(0, 2 * R0 - 2), r1 = min(h, 2 * (R0 + nr) + 1);  // full rows
  const int d0 = tile * te, d1 = min(d0 + te, halflen);
  const int K0 = d0 / c, K1 = (d1 - 1) / c;
  // full-row elements [fa, f1): the columns 2K-2 .. 2K+2 of the tile's K,
  // from a multiple of 8
  const int fa = (max(0, 2 * K0 - 2) * c) & ~7, f1 = min(w, 2 * K1 + 3) * c;
  const int fu = 8 * full_units(te, c);
  bf16* raw = reinterpret_cast<bf16*>(up_smem);  // BK_ROWS rows of fu elements
  bf16* acc = raw + BK_ROWS * fu;                // BK_BAND rows of fu
  const int64_t gi = (int64_t)img * h * rowlen;
  for (int r = r0; r < r1; ++r) {
    const int64_t off = gi + (int64_t)r * rowlen;
    stage_units(raw + (r - r0) * fu, g, off + fa, off + f1, gtot, vec, tid, UP_THREADS);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // acc(R, f) = bf16(sum over the taps t of wh[R, t] * g(2R-2+t, f)), in tap
  // order; a tap of weight 0 (every tap outside the image has it) adds a
  // zero product, which leaves a sum that starts at +0 as it is, and is
  // skipped.  Full row r's element fa sits at (sh0 + (r - r0) * rowlen) % 8
  // of its staged row: 0 for every row where rows start on 16 bytes.
  const int nf = (f1 - fa + 7) / 8;
  const int sh0 = (int)((gi + (int64_t)r0 * rowlen + fa) & 7), row7 = rowlen & 7;
  const bool even = sh0 == 0 && row7 == 0;
  // this thread's items: (half row R, chunk k) pairs tid, tid + UP_THREADS, ...
  for (int R = tid / nf, k = tid % nf; R < nr;) {
    const int Rg = R0 + R, rr = 2 * Rg - 2 - r0;  // tap t's staged row: rr + t
    float v[8] = {};
#pragma unroll
    for (int t = 0; t < TAPS; ++t) {
      const float wt = wh[Rg * TAPS + t];
      if (wt == 0.f) continue;
      const bf16* p = raw + (rr + t) * fu + 8 * k;
      float gv[8];
      if (even)
        unpack8(*reinterpret_cast<const uint4*>(p), gv);
      else
        load8(p + ((sh0 + (rr + t) * row7) & 7), gv);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = __fadd_rn(v[i], __fmul_rn(wt, gv[i]));
    }
    st8(acc + R * fu + 8 * k, v);
    for (k += UP_THREADS; k >= nf; k -= nf) ++R;
  }
  __syncthreads();

  // dx(R, K) = bf16(sum over u of ww[K, u] * acc(R, 2K-2+u)), in tap order
  // (taps.cuh).  Consecutive threads on consecutive elements (the acc
  // reads miss each other's banks); each element's taps and weights found
  // once for all the band's half rows.
  for (int d = d0 + tid; d < d1; d += UP_THREADS) {
    const int K = d / c, ch = d - K * c;
    float wk[TAPS];
    int jo[TAPS];
    w_taps(ww, K, w, wk, jo);
#pragma unroll
    for (int u = 0; u < TAPS; ++u) jo[u] = jo[u] * c + ch - fa;
    const int64_t row0 = ((int64_t)img * h2 + R0) * halflen + d;
    for (int R = 0; R < nr; ++R) {
      const bf16* ar = acc + R * fu;
      float v = 0.f;
#pragma unroll
      for (int u = 0; u < TAPS; ++u) v = tap_add(v, bf2f(ar[jo[u]]), wk[u]);
      dx[row0 + (int64_t)R * halflen] = f2bf(v);
    }
  }
}

// the largest tile of at most cap elements (a multiple of 8) whose shared
// memory fits a block, 0 if none does
template <class Smem>
int fitting_tile(int cap, int c, Smem smem) {
  while (cap > 8 && smem(cap, c) > (size_t)SMEM_MAX) cap -= 8;
  return smem(cap, c) > (size_t)SMEM_MAX ? 0 : cap;
}

bool aligned16(const void* a, const void* b) {
  return (((uintptr_t)a | (uintptr_t)b) & 15) == 0;
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
  if (n <= 0 || h2 < 2 || w2 < 2 || c <= 0 || 2 * w2 * c > 0x3fffffff || h2 > 0x3fffffff)
    return (int)cudaErrorInvalidValue;
  const int cap = fitting_tile(UP_TILE, (int)c, fwd_smem);
  int tiles;
  const int te = cap ? cut_row((int)(2 * w2 * c), cap, &tiles) : 0;
  const int64_t bands = (2 * h2 + UP_BAND - 1) / UP_BAND;
  if (!cap || n * bands * tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(te, (int)c);
  cudaFuncSetAttribute(up2_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  up2_fwd_kernel<<<(unsigned)(n * bands * tiles), UP_THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const int*)lo_w, (const float*)w0, (const float*)w1,
      (const int*)lo_h, (const float*)fa, (const float*)fb, (bf16*)y, (int)(2 * h2),
      (int)w2, (int)c, te, tiles, (int)bands, n * h2 * w2 * c, (int)aligned16(x, y));
  return (int)cudaGetLastError();
}

// g [N, 2*H2, 2*W2, C] -> dx [N, H2, W2, C]; wh [H2, 5], ww [W2, 5]
extern "C" int mimo_upsample2x_bwd(const void* g, const void* wh, const void* ww,
                                   void* dx, int64_t n, int64_t h2, int64_t w2,
                                   int64_t c, void* stream) {
  if (n <= 0 || h2 < 2 || w2 < 2 || c <= 0 || 2 * w2 * c > 0x3fffffff || h2 > 0x3fffffff)
    return (int)cudaErrorInvalidValue;
  const int cap = fitting_tile(BK_TILE, (int)c, bwd_smem);
  int tiles;
  const int te = cap ? cut_row((int)(w2 * c), cap, &tiles) : 0;
  const int64_t bands = (h2 + BK_BAND - 1) / BK_BAND;
  if (!cap || n * bands * tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem(te, (int)c);
  cudaFuncSetAttribute(up2_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  up2_bwd_kernel<<<(unsigned)(n * bands * tiles), UP_THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)g, (const float*)wh, (const float*)ww, (bf16*)dx, (int)h2, (int)w2,
      (int)c, te, tiles, (int)bands, n * 4 * h2 * w2 * c, (int)aligned16(g, g));
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
