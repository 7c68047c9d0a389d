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
// once, is bitwise the TPU kernel's dot.
//
// mimo_upsample_w2x_bwd (K4b) replaces its VJP, ct_resize.py:254
// _w2x_bwd_call (pallas_call :269; _w2x_bwd_rule :366): the cotangent row
// contracted with the same bf16 matrix.  Column K of a row takes full
// columns 2K-2 .. 2K+2 (the only nonzero entries of its matrix row),
// summed in f32 in that order with __fmul_rn / __fadd_rn and rounded once:
//   dx(K) = bf16(sum_u ww[K, u] * g(2K-2+u)), ww [W2, 5] the bf16 matrix
// entries (0 outside the image): the W pass of upsample2x.cu's backward,
// with the same tap helpers (taps.cuh).
//
// Both are bound on the H100 by device-memory bytes (read one side once,
// write the other, twice its size or half).  They run at that rate only
// with many bytes in flight and few instructions an element, and share
// one design:
//   * a tile is at most one 16-byte output unit a thread of one output
//     row, cut in elements (so any C fits: a 640-wide row of many
//     channels does not fit shared memory whole);
//   * blocks are persistent over the rows at their tile's columns (at
//     most K4_BLOCKS a launch, each taking at least K4_MIN_STAGES
//     stages).  A stage is up to K4_ROWS rows' input columns of the tile,
//     with their halo (one column for the forward, two full columns each
//     side for K4b), at most K4_STAGE_BYTES (K4B_STAGE_BYTES), copied
//     into shared memory as 16-byte units by cp.async, the next stage's
//     while this one is computed;
//   * a thread finds its unit's input offsets and weights once (one
//     division), for every row, and keeps them in registers;
//   * it builds a whole 16-byte output unit, 8 consecutive elements of the
//     row, from shared memory (channel pairs where C is even: one 4-byte
//     read a tap and pair), and stores it with one 16-byte store.
// A unit that a tile edge or the row's end cuts, a row that does not
// start on 16 bytes and an unaligned pointer take the element path, with
// the same arithmetic; odd C reads single channels.
#include "common.cuh"
#include "ptx.cuh"
#include "stage.cuh"
#include "taps.cuh"

namespace {

constexpr int K4_THREADS = 256;       // a tile: 8 * K4_THREADS output elements at most
constexpr int K4_STAGE_BYTES = 8192;   // bytes of input a stage holds at most
constexpr int K4_ROWS = 8;             // rows a stage at most
constexpr int K4_PER_SM = 4;           // blocks an SM
constexpr int K4_BLOCKS = K4_PER_SM * 132;  // blocks of a launch at most
constexpr int K4_MIN_STAGES = 2;       // stages a block takes at least
constexpr int K4B_THREADS = 256;       // K4b: a tile: 8 * K4B_THREADS output elements at most
constexpr int K4B_STAGE_BYTES = 24576;  // bytes of the cotangent a K4b stage holds at most
constexpr int K4B_PER_SM = 3;          // K4b blocks an SM
constexpr int SMEM_MAX = 232448;       // dynamic shared memory a block can have

// 16-byte units of a staged input row: the input columns of te output
// elements and their halo, from any element offset
__host__ __device__ __forceinline__ int k4_in_units(int te, int c) {
  return (te / 2 + 4 * c + 7) / 8 + 2;
}

// block K4_THREADS; blockIdx.x = tile * bpt + b: output-row elements
// [e0, e0 + te) of the rows of stages b, b + bpt, ... (a stage: rb rows).
// V = 2: C even, channel pairs.  vec: x and out are 16-byte aligned.
template <int V>
__global__ void __launch_bounds__(K4_THREADS, K4_PER_SM) upsample_w2x_kernel(
    const bf16* __restrict__ x, const int* __restrict__ lo, const float* __restrict__ w0,
    const float* __restrict__ w1, bf16* __restrict__ out, int64_t rows, int w2, int c,
    int te, int rb, int bpt, int vec) {
  extern __shared__ uint4 k4_smem[];
  constexpr int NP = 8 / V;  // pairs (elements) of an output unit
  const int tid = threadIdx.x;
  const int inlen = w2 * c, rowlen = 2 * inlen;
  const int tile = blockIdx.x / bpt, first = blockIdx.x - tile * bpt;
  const int e0 = tile * te, e1 = min(e0 + te, rowlen);
  const int i0 = lo[e0 / c] * c, i1 = (lo[(e1 - 1) / c] + 2) * c;  // input elements
  const int iu = 8 * k4_in_units(te, c);
  const int64_t nst = (rows + rb - 1) / rb;
  bf16* buf = reinterpret_cast<bf16*>(k4_smem);  // two stages of rb rows of iu
  auto stage = [&](int64_t s, int b) {
    const int64_t r0 = s * rb;
    const int nr = (int)min((int64_t)rb, rows - r0);
    for (int j = 0; j < nr; ++j) {
      const int64_t off = (r0 + j) * inlen;
      stage_units(buf + (b * rb + j) * iu, x, off + i0, off + i1, rows * inlen, vec, tid,
                  K4_THREADS);
    }
    cp_async_commit();
  };
  if (first < nst) stage(first, 0);

  // this thread's unit: output-row elements e .. e + 7; each pair's
  // (element's) input offset from i0 and its weights
  const int e = e0 + 8 * tid;
  int kk[NP];
  float u0[NP], u1[NP];
  {
    int q = e / c, ch = e - q * c;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const bool in = e + V * i < e1;
      kk[i] = in ? lo[q] * c + ch - i0 : 0;
      u0[i] = in ? w0[q] : 0.f;
      u1[i] = in ? w1[q] : 0.f;
      ch += V;  // V = 2: C is even, so a pair never crosses a column
      if (ch >= c) {
        ch -= c;
        ++q;
      }
    }
  }

  int b = 0;
  for (int64_t s = first; s < nst; s += bpt, b ^= 1) {
    cp_async_wait_all();
    __syncthreads();
    if (s + bpt < nst) stage(s + bpt, b ^ 1);
    const int64_t r0 = s * rb;
    const int nr = (int)min((int64_t)rb, rows - r0);
    if (e < e1)
      for (int j = 0; j < nr; ++j) {
        // row r0 + j's element i0 sits at its offset in a 16-byte unit
        const int64_t xo = (r0 + j) * inlen + i0, oo = (r0 + j) * rowlen;
        const bf16* rj = buf + (b * rb + j) * iu + (int)(xo & 7);
        float v[8];
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          float a[V], bb[V];
          load_bf16<V>(rj + kk[i], a);
          load_bf16<V>(rj + kk[i] + c, bb);
#pragma unroll
          for (int m = 0; m < V; ++m) v[V * i + m] = lerp2(a[m], u0[i], bb[m], u1[i]);
        }
        store8(out, oo + e, oo + e1, v, vec);
      }
  }
}

// A launch of persistent blocks over the rows at each of tiles tiles of
// the row: rows a stage (rb: stage_bytes of staged rows of row_bytes, at
// least one, at most K4_ROWS), blocks a tile (bpt: blocks over the tiles,
// at least one, at most one per K4_MIN_STAGES of the stages) and the
// shared memory of two stages; false if it does not fit.
struct Split {
  int rb, bpt;
  size_t smem;
};

bool split_rows(int64_t rows, int row_bytes, int stage_bytes, int tiles, int blocks,
                Split* sp) {
  int64_t rb = stage_bytes / row_bytes;
  rb = rb < 1 ? 1 : (rb > K4_ROWS ? K4_ROWS : rb);
  if (rb > rows) rb = rows;
  const int64_t nst = (rows + rb - 1) / rb;
  const int64_t most = (nst + K4_MIN_STAGES - 1) / K4_MIN_STAGES;
  const int64_t per = blocks / tiles > 0 ? blocks / tiles : 1;
  const int64_t bpt = per < most ? per : most;
  *sp = {(int)rb, (int)bpt, 2 * (size_t)rb * row_bytes};
  return sp->smem <= (size_t)SMEM_MAX && tiles * bpt <= 0x7fffffff;
}

bool aligned16(const void* a, const void* b) {
  return (((uintptr_t)a | (uintptr_t)b) & 15) == 0;
}

template <int V>
int k4_launch(const void* x, const void* lo, const void* w0, const void* w1, void* out,
              int64_t rows, int w2, int c, cudaStream_t stream) {
  int tiles;
  const int te = cut_row(2 * w2 * c, 8 * K4_THREADS, &tiles);
  Split sp;
  if (!split_rows(rows, 16 * k4_in_units(te, c), K4_STAGE_BYTES, tiles, K4_BLOCKS, &sp))
    return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(upsample_w2x_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)sp.smem);
  upsample_w2x_kernel<V><<<(unsigned)(tiles * sp.bpt), K4_THREADS, sp.smem, stream>>>(
      (const bf16*)x, (const int*)lo, (const float*)w0, (const float*)w1, (bf16*)out, rows,
      w2, c, te, sp.rb, sp.bpt, (int)aligned16(x, out));
  return (int)cudaGetLastError();
}

// K4b.  block K4B_THREADS; blockIdx.x = tile * bpt + b: dx-row elements
// [d0, d0 + te) of the rows of stages b, b + bpt, ... (a stage: rb rows of
// the cotangent's full columns 2K0-2 .. 2K1+2 of the tile's half columns
// K0 .. K1, clamped into the row).  V = 2: C even, channel pairs.  vec: g
// and dx are 16-byte aligned.
template <int V>
__global__ void __launch_bounds__(K4B_THREADS, K4B_PER_SM) upsample_w2x_bwd_kernel(
    const bf16* __restrict__ g, const float* __restrict__ ww, bf16* __restrict__ dx,
    int64_t rows, int w2, int c, int te, int rb, int bpt, int vec) {
  extern __shared__ uint4 k4_smem[];
  constexpr int NP = 8 / V;  // pairs (elements) of an output unit
  const int tid = threadIdx.x;
  const int w = 2 * w2, halflen = w2 * c, rowlen = w * c;
  const int tile = blockIdx.x / bpt, first = blockIdx.x - tile * bpt;
  const int d0 = tile * te, d1 = min(d0 + te, halflen);
  const int K0 = d0 / c, K1 = (d1 - 1) / c;
  const int f0 = max(0, 2 * K0 - 2) * c, f1 = min(w, 2 * K1 + 3) * c;  // full elements
  const int fu = 8 * full_units(te, c);
  const int64_t nst = (rows + rb - 1) / rb;
  bf16* buf = reinterpret_cast<bf16*>(k4_smem);  // two stages of rb rows of fu
  auto stage = [&](int64_t s, int b) {
    const int64_t r0 = s * rb;
    const int nr = (int)min((int64_t)rb, rows - r0);
    for (int j = 0; j < nr; ++j) {
      const int64_t off = (r0 + j) * rowlen;
      stage_units(buf + (b * rb + j) * fu, g, off + f0, off + f1, rows * rowlen, vec, tid,
                  K4B_THREADS);
    }
    cp_async_commit();
  };
  if (first < nst) stage(first, 0);

  // this thread's unit: dx-row elements d .. d + 7; each pair's (element's)
  // taps' offsets from f0 and their weights
  const int d = d0 + 8 * tid;
  int jo[NP][TAPS];
  float wk[NP][TAPS];
  {
    int K = d / c, ch = d - K * c;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const bool in = d + V * i < d1;
      w_taps(ww, in ? K : K0, w, wk[i], jo[i]);
#pragma unroll
      for (int u = 0; u < TAPS; ++u) jo[i][u] = in ? jo[i][u] * c + ch - f0 : 0;
      ch += V;  // V = 2: C is even, so a pair never crosses a column
      if (ch >= c) {
        ch -= c;
        ++K;
      }
    }
  }

  int b = 0;
  for (int64_t s = first; s < nst; s += bpt, b ^= 1) {
    cp_async_wait_all();
    __syncthreads();
    if (s + bpt < nst) stage(s + bpt, b ^ 1);
    const int64_t r0 = s * rb;
    const int nr = (int)min((int64_t)rb, rows - r0);
    if (d < d1)
      for (int j = 0; j < nr; ++j) {
        // row r0 + j's element f0 sits at its offset in a 16-byte unit
        const int64_t go = (r0 + j) * rowlen + f0, oo = (r0 + j) * halflen;
        const bf16* rj = buf + (b * rb + j) * fu + (int)(go & 7);
        float v[8];
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          float acc[V] = {};
#pragma unroll
          for (int u = 0; u < TAPS; ++u) {
            float gv[V];
            load_bf16<V>(rj + jo[i][u], gv);
#pragma unroll
            for (int m = 0; m < V; ++m) acc[m] = tap_add(acc[m], gv[m], wk[i][u]);
          }
#pragma unroll
          for (int m = 0; m < V; ++m) v[V * i + m] = acc[m];
        }
        store8(dx, oo + d, oo + d1, v, vec);
      }
  }
}

template <int V>
int k4b_launch(const void* g, const void* ww, void* dx, int64_t rows, int w2, int c,
               cudaStream_t stream) {
  int tiles;
  const int te = cut_row(w2 * c, 8 * K4B_THREADS, &tiles);
  Split sp;
  if (!split_rows(rows, 16 * full_units(te, c), K4B_STAGE_BYTES, tiles,
                  K4B_PER_SM * 132, &sp))
    return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(upsample_w2x_bwd_kernel<V>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sp.smem);
  upsample_w2x_bwd_kernel<V><<<(unsigned)(tiles * sp.bpt), K4B_THREADS, sp.smem, stream>>>(
      (const bf16*)g, (const float*)ww, (bf16*)dx, rows, w2, c, te, sp.rb, sp.bpt,
      (int)aligned16(g, dx));
  return (int)cudaGetLastError();
}

}  // namespace

// x [rows, W2, C] -> out [rows, 2*W2, C]; lo, w0, w1 [2*W2] (kernels/upsample_w2x.py
// _tables).  Refuses a row whose staged input columns do not fit a block.
extern "C" int mimo_upsample_w2x(const void* x, const void* lo, const void* w0,
                                 const void* w1, void* out, int64_t rows,
                                 int64_t w2, int64_t c, void* stream) {
  if (rows <= 0 || w2 < 2 || c <= 0 || 2 * w2 * c > 0x3fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (c % 2 == 0) return k4_launch<2>(x, lo, w0, w1, out, rows, (int)w2, (int)c, s);
  return k4_launch<1>(x, lo, w0, w1, out, rows, (int)w2, (int)c, s);
}

// g [rows, 2*W2, C] -> dx [rows, W2, C]; ww [W2, 5] (kernels/upsample_w2x.py
// _w_bwd_weights).  Refuses a row whose staged full columns do not fit a
// block.
extern "C" int mimo_upsample_w2x_bwd(const void* g, const void* ww, void* dx,
                                     int64_t rows, int64_t w2, int64_t c,
                                     void* stream) {
  if (rows <= 0 || w2 < 2 || c <= 0 || 2 * w2 * c > 0x3fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (c % 2 == 0) return k4b_launch<2>(g, ww, dx, rows, (int)w2, (int)c, s);
  return k4b_launch<1>(g, ww, dx, rows, (int)w2, (int)c, s);
}
