// Elementwise train-path kernels with per-group channel parameters, on
// channels-last bf16 [n, h*w, C] with the subnetwork groups folded S-major
// into n (image n uses group n / (n / groups)):
//   * mimo_g_eff: g = dy + dsum_g + 2*y*dsumsq_g, rounded to bf16: the
//     BatchNorm statistics' cotangents folded into the conv output's.
//     Replaces mimo_unet_tpu/ops/pallas/ct_elem.py:140 g_eff_ct
//     (_elem_call :71).
//   * mimo_affine_relu: z = relu(y*scale_g + shift_g), and
//     mimo_affine_relu_bwd: dy = da*scale, da = dz*[a > 0], with per-block
//     partials of dscale = sum da*y and dshift = sum da.  Replaces
//     ct_elem.py:83 affine_relu_ct and :106 _affine_relu_bwd.
//   * mimo_conv1x1_prelu: out = wo_g^T . bf16(relu(y*scale+shift)) + bo_g
//     (the decoder's last BatchNorm, ReLU and 1x1 out-conv), and
//     mimo_conv1x1_prelu_bwd: dy, with per-block partials of dwo, dbo,
//     dscale and dshift.  Replaces ct_elem.py:527 conv1x1_prelu_ct and :560
//     _conv1x1_prelu_bwd (pallas_call :600).
//   * mimo_conv1x1: out = wo_g^T . z + bo_g, the grouped 1x1 out-conv of
//     the dropout routes (a live dropout site sits between the decoder's
//     DoubleConv and its out-conv), and mimo_conv1x1_bwd: dz = wo_g . g,
//     with per-block partials of dwo and dbo.  Replaces ct_elem.py:437
//     conv1x1_ct (_elem_call :71) and :464 _conv1x1_bwd (pallas_call
//     :494).  The forward is conv1x1_prelu's kernel without the prologue
//     (the template flag PRO).
//   * mimo_reduce_groups: the second pass of every per-block reduction of
//     the train kernels (these and conv3x3_train.cu): out[g] = sum of the
//     group's partials, in a fixed order.
//
// What bounds them on the H100: device-memory bytes.  Each element takes a
// few flops against 2-6 bytes read and 2 written.  No atomics anywhere:
// results do not change from run to run.
//
// g_eff (K9) moves 6 bytes an element, so it runs at the memory's rate only
// if many bytes are in flight and the index arithmetic stays off the
// critical path.  A thread moves 16-byte chunks (8 bf16 of dy, of y and of
// g), GE_CHUNKS of them, neighbouring threads on neighbouring chunks; a
// block issues its loads first and only then finds where its span starts
// (one 64-bit division, by one thread), and each thread then walks its
// chunks' channel and group by 32-bit increments: no division per element.
// dsum/dsumsq come from a shared table of the block's first GE_GROUPS
// groups, replicated to o + 8 entries a group so that a chunk's eight
// channels read it without a wrap.  A chunk that a group boundary cuts, the
// ragged end, an unaligned pointer and a group past the table take a
// scalar path in the same kernel, with the same arithmetic.
//
// conv1x1_prelu_bwd (K12's backward) reads y and the logits' cotangent and
// writes dy, and reduces four sums per group.  Blocks are persistent within
// a group (at most K12_BLOCKS a launch, each taking at least K12_MIN_TILES
// tiles), so a launch writes a few hundred partial rows.  A tile is
// K12_TILE_BYTES of y and cotangent, cut in bytes whatever C.  Both are
// copied into shared memory as 16-byte units by cp.async (the next tile's
// while this one is computed) and read there by threads laid out as
// (pixel slice, channel) pairs over all 256 threads; dy is written back in
// place and stored as 16-byte units.  Each thread keeps its channel's sums
// in registers over all its block's tiles; the slices combine once at the
// end, in a fixed order.
//
// The other reducing passes (K8's and K11's backward) give each block 256
// pixels of one group and a 32 x 8 thread layout, channel x pixel lane;
// the eight lanes combine in shared memory in a fixed order and the block
// writes one partial per channel.
#include "common.cuh"
#include "ptx.cuh"

namespace {

constexpr int PB = 256;   // pixels per block of K8's and K11's reducing passes
constexpr int CMAX = 128;  // channels the 1x1 convs take (their shared tables)
constexpr int OCMAX = 8;  // out-conv channels

constexpr int GE_THREADS = 256;
constexpr int GE_CHUNKS = 4;                           // 16-byte chunks a thread
constexpr int GE_SPAN = GE_THREADS * GE_CHUNKS * 8;    // elements a block
constexpr int GE_GROUPS = 4;                           // groups in a block's table
constexpr int GE_OMAX = 256;                           // channels the table takes

constexpr int K12_THREADS = 256;
constexpr int K12_TILE_BYTES = 16384;  // bytes of y and cotangent a tile holds
constexpr int K12_PER_SM = 4;         // blocks an SM
constexpr int K12_BLOCKS = K12_PER_SM * 132;  // blocks of a launch at most
constexpr int K12_MIN_TILES = 4;      // tiles a block takes at least

__device__ __forceinline__ float affine(float y, float s, float b) {
  return __fadd_rn(__fmul_rn(y, s), b);
}

__device__ __forceinline__ float g_eff_of(float dy, float y, float ds, float dq) {
  return __fadd_rn(__fadd_rn(dy, ds), __fmul_rn(2.f * y, dq));
}

// r, an offset into group gi, brought back into its group
__device__ __forceinline__ void wrap_group(int64_t& r, int& gi, int64_t ge) {
  if (r < ge) return;
  if (r < 2 * ge) {
    r -= ge;
    ++gi;
  } else {  // groups shorter than a block's span
    const int64_t q = r / ge;
    gi += (int)q;
    r -= q * ge;
  }
}

// block GE_THREADS; grid ceil(total / GE_SPAN).  vec: dy, y and out are
// 16-byte aligned.
__global__ void __launch_bounds__(GE_THREADS) g_eff_kernel(
    const bf16* __restrict__ dy, const bf16* __restrict__ y,
    const float* __restrict__ ds, const float* __restrict__ dq,
    bf16* __restrict__ out, int64_t total, int64_t ge, int o, int groups, int vec) {
  __shared__ float tab[2][GE_GROUPS * (GE_OMAX + 8)];
  __shared__ int64_t head[3];
  const int tid = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * GE_SPAN;
  uint4 va[GE_CHUNKS], vb[GE_CHUNKS];
#pragma unroll
  for (int j = 0; j < GE_CHUNKS; ++j) {
    const int64_t e = base + 8 * (tid + j * GE_THREADS);
    if (vec && e + 8 <= total) {
      va[j] = *reinterpret_cast<const uint4*>(dy + e);
      vb[j] = *reinterpret_cast<const uint4*>(y + e);
    }
  }
  if (tid == 0) {  // the span's first group, offset in it and channel
    const int64_t g0 = base / ge;
    head[0] = g0;
    head[1] = base - g0 * ge;
    head[2] = base % o;
  }
  __syncthreads();
  const int g0 = (int)head[0];
  const int ow = o + 8;
  const bool tabled = o <= GE_OMAX;
  if (tabled)
    for (int i = tid; i < GE_GROUPS * ow; i += GE_THREADS) {
      const int gi = i / ow, g = g0 + gi;
      if (g < groups) {
        const int k = g * o + (i - gi * ow) % o;
        tab[0][i] = ds[k];
        tab[1][i] = dq[k];
      }
    }
  __syncthreads();
  int64_t r = head[1] + 8 * tid;  // this thread's chunk: offset in group g0 + gi
  int gi = 0;
  wrap_group(r, gi, ge);
  int c = ((int)head[2] + 8 * tid) % o;  // and channel
  const int dc = (8 * GE_THREADS) % o;
#pragma unroll
  for (int j = 0; j < GE_CHUNKS; ++j) {
    const int64_t e = base + 8 * (tid + j * GE_THREADS);
    if (e >= total) break;
    if (vec && tabled && e + 8 <= total && gi < GE_GROUPS && r + 8 <= ge) {
      const float* ts = tab[0] + gi * ow + c;
      const float* tq = tab[1] + gi * ow + c;
      float fa[8], fb[8], v[8];
      unpack8(va[j], fa);
      unpack8(vb[j], fb);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = g_eff_of(fa[i], fb[i], ts[i], tq[i]);
      st8(out + e, v);
    } else {
      int64_t rr = r;
      int g = g0 + gi, cc = c;
      for (int i = 0; i < 8 && e + i < total; ++i) {
        const int k = g * o + cc;
        out[e + i] = f2bf(g_eff_of(bf2f(dy[e + i]), bf2f(y[e + i]), ds[k], dq[k]));
        if (++cc == o) cc = 0;
        if (++rr == ge) {
          rr = 0;
          ++g;
        }
      }
    }
    r += 8 * GE_THREADS;
    wrap_group(r, gi, ge);
    c += dc;
    if (c >= o) c -= o;
  }
}

// A reducing block's pixels: group g's block b of ceil(group_pixels / PB),
// pixels [pix0, pix0 + count) of the flattened [n*hw] index.
struct Span {
  int g;
  int64_t pix0;
  int count;
};

__device__ __forceinline__ Span block_span(int64_t group_pixels) {
  const int64_t per = (group_pixels + PB - 1) / PB;
  const int g = (int)(blockIdx.x / per);
  const int64_t local = (blockIdx.x - g * per) * PB;
  return {g, g * group_pixels + local, (int)min((int64_t)PB, group_pixels - local)};
}

__global__ void affine_relu_kernel(const bf16* __restrict__ y,
                                   const float* __restrict__ sc,
                                   const float* __restrict__ sh,
                                   bf16* __restrict__ z, int64_t total,
                                   int64_t group_elems, int c) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const int64_t k = (e / group_elems) * c + e % c;
    const float a = affine(bf2f(y[e]), sc[k], sh[k]);
    z[e] = f2bf(a > 0.f ? a : 0.f);
  }
}

// sum v over the eight pixel lanes (threadIdx.y) in a fixed order; lane 0
// receives it.  red: 8 x 32 floats.
__device__ __forceinline__ float lane_sum(float* red, float v) {
  red[threadIdx.y * 32 + threadIdx.x] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.y == 0)
    for (int r = 0; r < 8; ++r) s += red[r * 32 + threadIdx.x];
  __syncthreads();
  return s;
}

// block (32, 8): channel lane x pixel lane; grid groups * ceil(group pixels / PB)
__global__ void __launch_bounds__(256) affine_relu_bwd_kernel(
    const bf16* __restrict__ dz, const bf16* __restrict__ y,
    const float* __restrict__ sc, const float* __restrict__ sh,
    bf16* __restrict__ dy, float* __restrict__ pdsc, float* __restrict__ pdsh,
    int64_t group_pixels, int c) {
  __shared__ float red[8 * 32];
  const Span sp = block_span(group_pixels);
  const int g = sp.g;
  for (int c0 = 0; c0 < c; c0 += 32) {
    const int ch = c0 + threadIdx.x;
    float s = 0.f, q = 0.f;
    if (ch < c) {
      const float scv = sc[g * c + ch], shv = sh[g * c + ch];
      for (int pp = threadIdx.y; pp < sp.count; pp += 8) {
        const int64_t e = (sp.pix0 + pp) * c + ch;
        const float yv = bf2f(y[e]);
        const float da = affine(yv, scv, shv) > 0.f ? bf2f(dz[e]) : 0.f;
        dy[e] = f2bf(__fmul_rn(da, scv));
        s = fmaf(da, yv, s);
        q += da;
      }
    }
    s = lane_sum(red, s);
    q = lane_sum(red, q);
    if (threadIdx.y == 0 && ch < c) {
      pdsc[blockIdx.x * (int64_t)c + ch] = s;
      pdsh[blockIdx.x * (int64_t)c + ch] = q;
    }
  }
}

// one thread per pixel; block up to PB pixels of one group.  PRO: z is the
// affine + ReLU of y rounded to bf16 (K12); else z = y (K11).
template <bool PRO>
__global__ void __launch_bounds__(PB) conv1x1_kernel(
    const bf16* __restrict__ y, const float* __restrict__ sc,
    const float* __restrict__ sh, const bf16* __restrict__ wo,
    const float* __restrict__ bo, bf16* __restrict__ out, int64_t group_pixels,
    int c, int oc) {
  __shared__ float s_sc[CMAX], s_sh[CMAX], s_wo[CMAX * OCMAX], s_bo[OCMAX];
  const Span sp = block_span(group_pixels);
  const int g = sp.g;
  if constexpr (PRO)
    for (int i = threadIdx.x; i < c; i += PB) {
      s_sc[i] = sc[g * c + i];
      s_sh[i] = sh[g * c + i];
    }
  for (int i = threadIdx.x; i < c * oc; i += PB) s_wo[i] = bf2f(wo[(int64_t)g * c * oc + i]);
  for (int i = threadIdx.x; i < oc; i += PB) s_bo[i] = bo[g * oc + i];
  __syncthreads();
  if ((int)threadIdx.x >= sp.count) return;
  const int64_t pix = sp.pix0 + threadIdx.x;
  float acc[OCMAX] = {};
  for (int ch = 0; ch < c; ++ch) {
    float z = bf2f(y[pix * c + ch]);
    if constexpr (PRO) {
      const float a = affine(z, s_sc[ch], s_sh[ch]);
      z = bf2f(f2bf(a > 0.f ? a : 0.f));
    }
#pragma unroll
    for (int k = 0; k < OCMAX; ++k)
      if (k < oc) acc[k] = fmaf(z, s_wo[ch * oc + k], acc[k]);
  }
#pragma unroll
  for (int k = 0; k < OCMAX; ++k)
    if (k < oc) out[pix * oc + k] = f2bf(__fadd_rn(acc[k], s_bo[k]));
}

// K11's backward.  block (32, 8): channel lane x pixel lane; grid groups *
// ceil(group pixels / PB).  Partial row of a block: [dwo (c*oc), dbo (oc)].
__global__ void __launch_bounds__(256) conv1x1_bwd_kernel(
    const bf16* __restrict__ gout, const bf16* __restrict__ z,
    const bf16* __restrict__ wo, bf16* __restrict__ dz,
    float* __restrict__ partial, int64_t group_pixels, int c, int oc) {
  __shared__ float red[8 * 32];
  const Span sp = block_span(group_pixels);
  const int g = sp.g;
  float* prow = partial + blockIdx.x * (int64_t)(c * oc + oc);
  for (int c0 = 0; c0 < c; c0 += 32) {
    const int ch = c0 + threadIdx.x;
    const bool live = ch < c;
    float w[OCMAX] = {}, dwo[OCMAX] = {}, dbo[OCMAX] = {};
    if (live)
      for (int k = 0; k < oc; ++k) w[k] = bf2f(wo[((int64_t)g * c + ch) * oc + k]);
    for (int pp = threadIdx.y; pp < sp.count; pp += 8) {
      const int64_t pix = sp.pix0 + pp;
      float gk[OCMAX];
#pragma unroll
      for (int k = 0; k < OCMAX; ++k) gk[k] = k < oc ? bf2f(gout[pix * oc + k]) : 0.f;
      if (c0 == 0 && threadIdx.x == 0)
#pragma unroll
        for (int k = 0; k < OCMAX; ++k) dbo[k] += gk[k];
      if (!live) continue;
      const float zv = bf2f(z[pix * c + ch]);
      float d = 0.f;
#pragma unroll
      for (int k = 0; k < OCMAX; ++k) {
        d = fmaf(w[k], gk[k], d);
        dwo[k] = fmaf(zv, gk[k], dwo[k]);
      }
      dz[pix * c + ch] = f2bf(d);
    }
    for (int k = 0; k < oc; ++k) {
      const float v = lane_sum(red, dwo[k]);
      if (threadIdx.y == 0 && live) prow[ch * oc + k] = v;
    }
    if (c0 == 0)
      for (int k = 0; k < oc; ++k) {
        const float v = lane_sum(red, dbo[k]);
        if (threadIdx.y == 0 && threadIdx.x == 0) prow[c * oc + k] = v;
      }
  }
}

// ---- K12's backward: persistent blocks over staged tiles

// pixels of a tile: K12_TILE_BYTES of y (c channels) and the cotangent
// (oc), a multiple of 8
__host__ __device__ __forceinline__ int prelu_bwd_tile(int c, int oc) {
  const int t = (K12_TILE_BYTES / (2 * (c + oc))) & ~7;
  return t < 8 ? 8 : t;
}

// 16-byte units that hold px runs of k bf16 from any element offset
__host__ __device__ __forceinline__ int units_of(int px, int k) {
  return (px * k + 7) / 8 + 1;
}

// copy elements [e0, e1) of src (tot elements) into dst as the 16-byte
// units that hold them: dst[i] = src[8 * (e0 / 8) + i].  Whole units by
// cp.async where src is 16-byte aligned (vec), the tensor's ragged end and
// an unaligned src by ld8.
__device__ __forceinline__ void stage_units(bf16* dst, const bf16* src, int64_t e0,
                                            int64_t e1, int64_t tot, int vec, int tid) {
  const int64_t u0 = e0 >> 3;
  const int n = (int)(((e1 + 7) >> 3) - u0);
  for (int i = tid; i < n; i += K12_THREADS) {
    const int64_t e = (u0 + i) * 8;
    if (vec && e + 8 <= tot)
      cp_async16(dst + 8 * i, src + e);
    else
      *reinterpret_cast<uint4*>(dst + 8 * i) = ld8(src + e, (int)min((int64_t)8, tot - e));
  }
}

// write elements [e0, e1) of dst from units staged as stage_units stages
// them: whole units as 16-byte stores (vec), a unit the range cuts element
// by element
__device__ __forceinline__ void store_units(bf16* dst, const bf16* src, int64_t e0,
                                            int64_t e1, int vec, int tid) {
  const int64_t u0 = e0 >> 3;
  const int n = (int)(((e1 + 7) >> 3) - u0);
  for (int i = tid; i < n; i += K12_THREADS) {
    const int64_t e = (u0 + i) * 8;
    if (vec && e >= e0 && e + 8 <= e1) {
      *reinterpret_cast<uint4*>(dst + e) = *reinterpret_cast<const uint4*>(src + 8 * i);
    } else {
      for (int k = 0; k < 8; ++k)
        if (e + k >= e0 && e + k < e1) dst[e + k] = src[8 * i + k];
    }
  }
}

// block K12_THREADS; grid groups * bpg, block b of group b / bpg taking
// the group's tiles b % bpg, + bpg, ...  Partial row of a block:
// [dwo (c*OC), dbo (OC), dscale (c), dshift (c)].  vec: g, y and dy are
// 16-byte aligned.
template <int OC>
__global__ void __launch_bounds__(K12_THREADS, K12_PER_SM) conv1x1_prelu_bwd_kernel(
    const bf16* __restrict__ gout, const bf16* __restrict__ y,
    const float* __restrict__ sc, const float* __restrict__ sh,
    const bf16* __restrict__ wo, bf16* __restrict__ dy,
    float* __restrict__ partial, int64_t pixels, int64_t gp, int c, int bpg, int vec) {
  extern __shared__ uint4 k12_smem[];
  const int tid = threadIdx.x;
  const int tp = prelu_bwd_tile(c, OC);
  const int yu = units_of(tp, c), gu = units_of(tp, OC);
  const int grp = blockIdx.x / bpg;
  const int64_t ntiles = (gp + tp - 1) / tp;
  const int64_t first = blockIdx.x - (int64_t)grp * bpg;
  const int ns = K12_THREADS / c;  // pixel slices
  const int sl = tid / c, ch = tid - sl * c;
  const bool live = sl < ns;

  float w[OC], dwo[OC], dbo[OC];
  float scv = 0.f, shv = 0.f, s = 0.f, q = 0.f;
#pragma unroll
  for (int k = 0; k < OC; ++k) {
    w[k] = live ? bf2f(wo[((int64_t)grp * c + ch) * OC + k]) : 0.f;
    dwo[k] = dbo[k] = 0.f;
  }
  if (live) {
    scv = sc[grp * c + ch];
    shv = sh[grp * c + ch];
  }

  // tile t: pixels [p0, p0 + count) of the flattened index; buffer b: y's
  // units, then the cotangent's
  auto tile = [&](int64_t t, int64_t& p0) {
    p0 = grp * gp + t * tp;
    return (int)min((int64_t)tp, gp - t * tp);
  };
  auto ybuf = [&](int b) { return reinterpret_cast<bf16*>(k12_smem + b * (yu + gu)); };
  auto gbuf = [&](int b) { return reinterpret_cast<bf16*>(k12_smem + b * (yu + gu) + yu); };
  auto stage = [&](int64_t t, int b) {
    int64_t p0;
    const int cnt = tile(t, p0);
    stage_units(ybuf(b), y, p0 * c, (p0 + cnt) * c, pixels * c, vec, tid);
    stage_units(gbuf(b), gout, p0 * OC, (p0 + cnt) * OC, pixels * OC, vec, tid);
    cp_async_commit();
  };

  if (first < ntiles) stage(first, 0);
  int b = 0;
  for (int64_t t = first; t < ntiles; t += bpg, b ^= 1) {
    cp_async_wait_all();
    __syncthreads();
    if (t + bpg < ntiles) stage(t + bpg, b ^ 1);
    int64_t p0;
    const int cnt = tile(t, p0);
    bf16* ys = ybuf(b) + ((p0 * c) & 7);
    const bf16* gs = gbuf(b) + ((p0 * OC) & 7);
    if (live)
      for (int p = sl; p < cnt; p += ns) {
        bf16* yp = ys + p * c + ch;
        const float yv = bf2f(*yp);
        float gk[OC];
        if constexpr (OC % 2 == 0) {
#pragma unroll
          for (int k = 0; k < OC; k += 2) load_bf16<2>(gs + p * OC + k, gk + k);
        } else {
#pragma unroll
          for (int k = 0; k < OC; ++k) gk[k] = bf2f(gs[p * OC + k]);
        }
        const float a = affine(yv, scv, shv);
        const float z = bf2f(f2bf(a > 0.f ? a : 0.f));
        float dz = 0.f;
#pragma unroll
        for (int k = 0; k < OC; ++k) {
          dz = fmaf(w[k], gk[k], dz);
          dwo[k] = fmaf(z, gk[k], dwo[k]);
        }
        if (ch == 0)
#pragma unroll
          for (int k = 0; k < OC; ++k) dbo[k] += gk[k];
        const float da = a > 0.f ? dz : 0.f;
        *yp = f2bf(__fmul_rn(da, scv));  // dy in place of y
        s = fmaf(da, yv, s);
        q += da;
      }
    __syncthreads();
    store_units(dy, ybuf(b), p0 * c, (p0 + cnt) * c, vec, tid);
  }
  __syncthreads();  // the tiles' buffers become the slices' sums

  // each output's ns slice sums in order
  float* red = reinterpret_cast<float*>(k12_smem);
  const int L = c * OC + OC + 2 * c;
  if (live) {
#pragma unroll
    for (int k = 0; k < OC; ++k) red[(ch * OC + k) * ns + sl] = dwo[k];
    if (ch == 0)
#pragma unroll
      for (int k = 0; k < OC; ++k) red[(c * OC + k) * ns + sl] = dbo[k];
    red[(c * OC + OC + ch) * ns + sl] = s;
    red[(c * OC + OC + c + ch) * ns + sl] = q;
  }
  __syncthreads();
  float* prow = partial + (int64_t)blockIdx.x * L;
  for (int l = tid; l < L; l += K12_THREADS) {
    float v = 0.f;
    for (int r = 0; r < ns; ++r) v += red[l * ns + r];
    prow[l] = v;
  }
}

// out[g, l] = sum_p partial[g, p, l]; block (32, 16): l lane x p lane,
// grid (ceil(l / 32), groups)
__global__ void reduce_groups_kernel(const float* __restrict__ partial,
                                     float* __restrict__ out, int64_t p, int64_t l) {
  __shared__ float red[16 * 32];
  const int64_t col = (int64_t)blockIdx.x * 32 + threadIdx.x;
  const float* base = partial + (int64_t)blockIdx.y * p * l;
  float s = 0.f;
  if (col < l)
    for (int64_t r = threadIdx.y; r < p; r += 16) s += base[r * l + col];
  red[threadIdx.y * 32 + threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < l) {
    float t = 0.f;
    for (int r = 0; r < 16; ++r) t += red[r * 32 + threadIdx.x];
    out[(int64_t)blockIdx.y * l + col] = t;
  }
}

int bad() { return (int)cudaErrorInvalidValue; }

bool aligned16(const void* a, const void* b, const void* c) {
  return (((uintptr_t)a | (uintptr_t)b | (uintptr_t)c) & 15) == 0;
}

// blocks of a reducing pass: ceil(group pixels / PB) per group
unsigned reducing_blocks(int64_t n, int64_t hw, int64_t groups) {
  return (unsigned)(groups * ((n / groups * hw + PB - 1) / PB));
}

// K12 backward's blocks a group: K12_BLOCKS over the groups, at least one,
// and at most one per K12_MIN_TILES of the group's tiles
// (kernels/train_elem.py prelu_bwd_blocks mirrors it)
int64_t prelu_bwd_blocks(int64_t gp, int c, int oc, int64_t groups) {
  const int tp = prelu_bwd_tile(c, oc);
  const int64_t tiles = (gp + tp - 1) / tp;
  const int64_t most = (tiles + K12_MIN_TILES - 1) / K12_MIN_TILES;
  const int64_t per = K12_BLOCKS / groups > 0 ? K12_BLOCKS / groups : 1;
  return per < most ? per : most;
}

// shared memory of K12 backward: two tiles' buffers, or the slices' sums
size_t prelu_bwd_smem(int c, int oc) {
  const int tp = prelu_bwd_tile(c, oc);
  const size_t tiles = 2 * 16 * (size_t)(units_of(tp, c) + units_of(tp, oc));
  const size_t sums = 4 * (size_t)(c * oc + oc + 2 * c) * (K12_THREADS / c);
  return tiles > sums ? tiles : sums;
}

}  // namespace

extern "C" int mimo_g_eff(const void* dy, const void* y, const void* dsum,
                          const void* dsumsq, void* out, int64_t n, int64_t hw,
                          int64_t o, int64_t groups, void* stream) {
  if (n <= 0 || hw <= 0 || o <= 0 || groups <= 0 || n % groups) return bad();
  const int64_t total = n * hw * o;
  const int64_t blocks = (total + GE_SPAN - 1) / GE_SPAN;
  if (blocks > 0x7fffffff || groups * o > 0x7fffffff) return bad();
  g_eff_kernel<<<(unsigned)blocks, GE_THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)dy, (const bf16*)y, (const float*)dsum, (const float*)dsumsq,
      (bf16*)out, total, n / groups * hw * o, (int)o, (int)groups,
      (int)aligned16(dy, y, out));
  return (int)cudaGetLastError();
}

extern "C" int mimo_affine_relu(const void* y, const void* sc, const void* sh,
                                void* z, int64_t n, int64_t hw, int64_t c,
                                int64_t groups, void* stream) {
  if (n <= 0 || hw <= 0 || c <= 0 || groups <= 0 || n % groups) return bad();
  const int64_t total = n * hw * c;
  affine_relu_kernel<<<elementwise_blocks(total, 256), 256, 0, (cudaStream_t)stream>>>(
      (const bf16*)y, (const float*)sc, (const float*)sh, (bf16*)z, total,
      n / groups * hw * c, (int)c);
  return (int)cudaGetLastError();
}

extern "C" int mimo_affine_relu_bwd(const void* dz, const void* y, const void* sc,
                                    const void* sh, void* dy, void* pdsc,
                                    void* pdsh, int64_t n, int64_t hw, int64_t c,
                                    int64_t groups, void* stream) {
  if (n <= 0 || hw <= 0 || c <= 0 || groups <= 0 || n % groups) return bad();
  affine_relu_bwd_kernel<<<reducing_blocks(n, hw, groups), dim3(32, 8), 0,
                           (cudaStream_t)stream>>>(
      (const bf16*)dz, (const bf16*)y, (const float*)sc, (const float*)sh,
      (bf16*)dy, (float*)pdsc, (float*)pdsh, n / groups * hw, (int)c);
  return (int)cudaGetLastError();
}

namespace {

bool bad_1x1(int64_t n, int64_t hw, int64_t c, int64_t oc, int64_t groups) {
  return n <= 0 || hw <= 0 || c <= 0 || c > CMAX || oc <= 0 || oc > OCMAX ||
         groups <= 0 || n % groups;
}

template <bool PRO>
int conv1x1_launch(const void* y, const void* sc, const void* sh, const void* wo,
                   const void* bo, void* out, int64_t n, int64_t hw, int64_t c,
                   int64_t oc, int64_t groups, void* stream) {
  if (bad_1x1(n, hw, c, oc, groups)) return bad();
  conv1x1_kernel<PRO><<<reducing_blocks(n, hw, groups), PB, 0,
                       (cudaStream_t)stream>>>(
      (const bf16*)y, (const float*)sc, (const float*)sh, (const bf16*)wo,
      (const float*)bo, (bf16*)out, n / groups * hw, (int)c, (int)oc);
  return (int)cudaGetLastError();
}

template <int OC>
int prelu_bwd_launch(const void* g, const void* y, const void* sc, const void* sh,
                     const void* wo, void* dy, void* partial, int64_t n, int64_t hw,
                     int c, int64_t groups, cudaStream_t stream) {
  const int64_t gp = n / groups * hw;
  const int64_t bpg = prelu_bwd_blocks(gp, c, OC, groups);
  conv1x1_prelu_bwd_kernel<OC><<<(unsigned)(groups * bpg), K12_THREADS,
                                  prelu_bwd_smem(c, OC), stream>>>(
      (const bf16*)g, (const bf16*)y, (const float*)sc, (const float*)sh,
      (const bf16*)wo, (bf16*)dy, (float*)partial, n * hw, gp, c, (int)bpg,
      (int)aligned16(g, y, dy));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mimo_conv1x1_prelu(const void* y, const void* sc, const void* sh,
                                  const void* wo, const void* bo, void* out,
                                  int64_t n, int64_t hw, int64_t c, int64_t oc,
                                  int64_t groups, void* stream) {
  return conv1x1_launch<true>(y, sc, sh, wo, bo, out, n, hw, c, oc, groups,
                              stream);
}

extern "C" int mimo_conv1x1_prelu_bwd(const void* g, const void* y,
                                      const void* sc, const void* sh,
                                      const void* wo, void* dy, void* partial,
                                      int64_t n, int64_t hw, int64_t c,
                                      int64_t oc, int64_t groups, void* stream) {
  if (bad_1x1(n, hw, c, oc, groups) || groups > 0x7fffffff / K12_BLOCKS) return bad();
  const cudaStream_t st = (cudaStream_t)stream;
  switch (oc) {
    case 1: return prelu_bwd_launch<1>(g, y, sc, sh, wo, dy, partial, n, hw, (int)c, groups, st);
    case 2: return prelu_bwd_launch<2>(g, y, sc, sh, wo, dy, partial, n, hw, (int)c, groups, st);
    case 3: return prelu_bwd_launch<3>(g, y, sc, sh, wo, dy, partial, n, hw, (int)c, groups, st);
    case 4: return prelu_bwd_launch<4>(g, y, sc, sh, wo, dy, partial, n, hw, (int)c, groups, st);
    case 5: return prelu_bwd_launch<5>(g, y, sc, sh, wo, dy, partial, n, hw, (int)c, groups, st);
    case 6: return prelu_bwd_launch<6>(g, y, sc, sh, wo, dy, partial, n, hw, (int)c, groups, st);
    case 7: return prelu_bwd_launch<7>(g, y, sc, sh, wo, dy, partial, n, hw, (int)c, groups, st);
    default: return prelu_bwd_launch<8>(g, y, sc, sh, wo, dy, partial, n, hw, (int)c, groups, st);
  }
}

extern "C" int mimo_conv1x1(const void* z, const void* wo, const void* bo,
                            void* out, int64_t n, int64_t hw, int64_t c,
                            int64_t oc, int64_t groups, void* stream) {
  return conv1x1_launch<false>(z, nullptr, nullptr, wo, bo, out, n, hw, c, oc,
                               groups, stream);
}

extern "C" int mimo_conv1x1_bwd(const void* g, const void* z, const void* wo,
                                void* dz, void* partial, int64_t n, int64_t hw,
                                int64_t c, int64_t oc, int64_t groups,
                                void* stream) {
  if (bad_1x1(n, hw, c, oc, groups)) return bad();
  conv1x1_bwd_kernel<<<reducing_blocks(n, hw, groups), dim3(32, 8), 0,
                       (cudaStream_t)stream>>>(
      (const bf16*)g, (const bf16*)z, (const bf16*)wo, (bf16*)dz, (float*)partial,
      n / groups * hw, (int)c, (int)oc);
  return (int)cudaGetLastError();
}

extern "C" int mimo_reduce_groups(const void* partial, void* out, int64_t groups,
                                  int64_t p, int64_t l, void* stream) {
  if (groups <= 0 || groups > 65535 || p <= 0 || l <= 0) return bad();
  const dim3 grid((unsigned)((l + 31) / 32), (unsigned)groups);
  reduce_groups_kernel<<<grid, dim3(32, 16), 0, (cudaStream_t)stream>>>(
      (const float*)partial, (float*)out, p, l);
  return (int)cudaGetLastError();
}
