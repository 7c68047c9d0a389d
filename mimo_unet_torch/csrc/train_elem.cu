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
//     :494).  Both are conv1x1_prelu's kernels without the prologue (the
//     template flag PRO).
//   * mimo_reduce_groups: the second pass of every per-block reduction of
//     the train kernels (these and conv3x3_train.cu): out[g] = sum of the
//     group's partials, in a fixed order.
//
// What bounds them on the H100: device-memory bytes.  Each element takes a
// few flops against 2-6 bytes read and 2 written.  No atomics anywhere:
// results do not change from run to run.
//
// g_eff (K9) and affine_relu (K8's forward) are one streaming pass,
// chunk_kernel<Op> (Op: the element's f32 expression).  They run at the
// memory's rate only if many bytes are in flight and the index arithmetic
// stays off the critical path.  A thread moves 16-byte chunks (8 bf16 of
// each input and of the output), GE_CHUNKS of them, neighbouring threads
// on neighbouring chunks; a block issues its loads first and only then
// finds where its span starts (one 64-bit division, by one thread), and
// each thread then walks its chunks' channel and group by 32-bit
// increments: no division per element.  The parameters come from a shared
// table of the block's first GE_GROUPS groups, replicated to o + 8
// entries a group so that a chunk's eight channels read it without a wrap.
// A chunk that a group boundary cuts, the ragged end, an unaligned pointer
// and a group past the table take a scalar path in the same kernel, with
// the same arithmetic.
//
// The backward of the BatchNorm affine and ReLU, affine_bwd_kernel<PRO,
// OC>, serves K12 (PRO, OC > 0: the cotangent is the logits', and dz =
// wo . g is the 1x1 out-conv's transpose) and K8 (PRO, OC = 0: dz is
// read); without the prologue (PRO false) it is K11's backward, dz = wo .
// g itself, with no affine, ReLU mask, dscale or dshift.  It reads y (z
// for K11) and the cotangent and writes dy (dz), and reduces its sums per
// group.  Blocks are persistent within a group (at most K12_BLOCKS a
// launch, each taking at least K12_MIN_TILES tiles), so a launch writes a
// few hundred partial rows.  A tile is K12_TILE_BYTES of y and
// cotangent, cut in bytes whatever C.  Both are copied into shared memory
// as 16-byte units by cp.async (the next tile's while this one is
// computed) and read there by threads laid out as (pixel slice, channel)
// pairs over all 256 threads; dy is written back in place and stored as
// 16-byte units.  Each thread keeps its channel's sums in registers over
// all its block's tiles; the slices combine once at the end, in a fixed
// order.
//
// The 1x1 out-conv forward, conv1x1_kernel<PRO, OC>, serves K12 (PRO: the
// BatchNorm affine and ReLU first) and K11's forward.  It reads y (C
// channels a pixel) and writes OC <= 8 logits, a tenth of the bytes at
// C = 21.  Its blocks are persistent within a group as the backward's are
// (at most K12F_BLOCKS a launch, each taking at least K12_MIN_TILES tiles),
// and load the group's scale, shift, wo and bo once, as one record of
// floats a channel.  A tile is K12F_TILE_BYTES of y and logits (a
// multiple of the block's threads in pixels where that many fit), copied
// into shared memory as 16-byte units by cp.async, the next tile's while
// this one is computed.  A thread computes two pixels of a tile, each
// one's OC sums in channel order (the rounding points and order of the
// one-pixel-a-thread kernel it replaced: the same bits), reading a
// pixel's channels from the staged tile eight at a time where C is a
// multiple of 8 (16-byte units; scalar reads of lanes 2C bytes apart
// conflict on the banks there); the logits are written to shared memory
// and stored as 16-byte units after the next tile's barrier (one barrier
// a tile).
#include "common.cuh"
#include "ptx.cuh"
#include "stage.cuh"

namespace {

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
constexpr int K12F_TILE_BYTES = 24576;  // bytes of y and logits a forward tile holds
constexpr int K12F_PER_SM = 3;          // forward blocks an SM
constexpr int K12F_BLOCKS = K12F_PER_SM * 132;  // forward blocks of a launch at most

__device__ __forceinline__ float affine(float y, float s, float b) {
  return __fadd_rn(__fmul_rn(y, s), b);
}

// the elementwise functions of chunk_kernel: out = f(dy, y, p_g, q_g), one
// f32 expression, rounded once
struct g_eff_op {  // K9: dy + dsum + 2*y*dsumsq
  static constexpr bool DY = true;  // reads dy beside y
  __device__ static float f(float dy, float y, float ds, float dq) {
    return __fadd_rn(__fadd_rn(dy, ds), __fmul_rn(2.f * y, dq));
  }
};

struct affine_relu_op {  // K8: relu(y*scale + shift)
  static constexpr bool DY = false;
  __device__ static float f(float, float y, float sc, float sh) {
    const float a = affine(y, sc, sh);
    return a > 0.f ? a : 0.f;
  }
};

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

// block GE_THREADS; grid ceil(total / GE_SPAN).  vec: dy (where read), y
// and out are 16-byte aligned.
template <class Op>
__global__ void __launch_bounds__(GE_THREADS) chunk_kernel(
    const bf16* __restrict__ dy, const bf16* __restrict__ y,
    const float* __restrict__ p, const float* __restrict__ q,
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
      if constexpr (Op::DY) va[j] = *reinterpret_cast<const uint4*>(dy + e);
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
        tab[0][i] = p[k];
        tab[1][i] = q[k];
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
      const float* tp = tab[0] + gi * ow + c;
      const float* tq = tab[1] + gi * ow + c;
      float fa[8] = {}, fb[8], v[8];
      if constexpr (Op::DY) unpack8(va[j], fa);
      unpack8(vb[j], fb);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = Op::f(fa[i], fb[i], tp[i], tq[i]);
      st8(out + e, v);
    } else {
      int64_t rr = r;
      int g = g0 + gi, cc = c;
      for (int i = 0; i < 8 && e + i < total; ++i) {
        const int k = g * o + cc;
        float a = 0.f;
        if constexpr (Op::DY) a = bf2f(dy[e + i]);
        out[e + i] = f2bf(Op::f(a, bf2f(y[e + i]), p[k], q[k]));
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

// pixels of a forward tile: K12F_TILE_BYTES of y (c channels) and logits
// (oc), a multiple of the block's threads where that many fit, else of 8
__host__ __device__ __forceinline__ int fwd_tile(int c, int oc) {
  const int t = K12F_TILE_BYTES / (2 * (c + oc));
  return t >= K12_THREADS ? t / K12_THREADS * K12_THREADS : (t < 8 ? 8 : t & ~7);
}

// floats of a channel's parameter record in the forward's table: scale and
// shift (PRO), then the channel's OC out-conv weights, padded to 16 bytes
template <bool PRO, int OC>
__host__ __device__ __forceinline__ constexpr int fwd_record() {
  return ((PRO ? 2 : 0) + OC + 3) & ~3;
}

// The 1x1 out-conv forward: block K12_THREADS; grid groups * bpg, block b
// of group b / bpg taking the group's tiles b % bpg, + bpg, ...  PRO: z is
// the affine + ReLU of y rounded to bf16 (K12); else z = y (K11).  A
// thread computes pixels p and p + K12_THREADS of a tile, each one's OC
// sums in channel order, from the staged tile and the channel records;
// the logits go to shared memory and leave as 16-byte units.  vec: y and
// out are 16-byte aligned.
template <bool PRO, int OC>
__global__ void __launch_bounds__(K12_THREADS, K12F_PER_SM) conv1x1_kernel(
    const bf16* __restrict__ y, const float* __restrict__ sc,
    const float* __restrict__ sh, const bf16* __restrict__ wo,
    const float* __restrict__ bo, bf16* __restrict__ out, int64_t pixels, int64_t gp,
    int c, int bpg, int vec) {
  extern __shared__ uint4 k12_smem[];
  constexpr int RS = fwd_record<PRO, OC>(), W0 = PRO ? 2 : 0;
  const int tid = threadIdx.x;
  const int tp = fwd_tile(c, OC);
  const int yu = units_of(tp, c), ou = units_of(tp, OC);
  const int grp = blockIdx.x / bpg;
  const int64_t ntiles = (gp + tp - 1) / tp;
  const int64_t first = blockIdx.x - (int64_t)grp * bpg;
  bf16* obuf = reinterpret_cast<bf16*>(k12_smem + 2 * yu);  // two tiles' logits
  float* rec = reinterpret_cast<float*>(k12_smem + 2 * yu + 2 * ou);  // c records of RS
  auto tile = [&](int64_t t, int64_t& p0) {
    p0 = grp * gp + t * tp;
    return (int)min((int64_t)tp, gp - t * tp);
  };
  auto stage = [&](int64_t t, int b) {
    int64_t p0;
    const int cnt = tile(t, p0);
    stage_units(reinterpret_cast<bf16*>(k12_smem + b * yu), y, p0 * c, (p0 + cnt) * c,
                pixels * c, vec, tid, K12_THREADS);
    cp_async_commit();
  };
  auto store = [&](int64_t t, int b) {  // tile t's logits, from buffer b
    int64_t p0;
    const int cnt = tile(t, p0);
    store_units(out, obuf + b * 8 * ou, p0 * OC, (p0 + cnt) * OC, vec, tid, K12_THREADS);
  };
  if (first < ntiles) stage(first, 0);

  // the group's parameters, once a block
  for (int i = tid; i < c * RS; i += K12_THREADS) {
    const int ch = i / RS, r = i - ch * RS;
    float v = 0.f;
    if (PRO && r == 0)
      v = sc[grp * c + ch];
    else if (PRO && r == 1)
      v = sh[grp * c + ch];
    else if (r >= W0 && r < W0 + OC)
      v = bf2f(wo[((int64_t)grp * c + ch) * OC + r - W0]);
    rec[i] = v;
  }
  float bias[OC];
#pragma unroll
  for (int k = 0; k < OC; ++k) bias[k] = bo[grp * OC + k];

  // the tile and its logits in buffer b; a tile's logits leave in the next
  // iteration, after its barrier: one barrier a tile
  int b = 0;
  int64_t t = first;
  for (; t < ntiles; t += bpg, b ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // tile t staged, the records, tile t - bpg's logits
    if (t + bpg < ntiles) stage(t + bpg, b ^ 1);
    if (t > first) store(t - bpg, b ^ 1);
    int64_t p0;
    const int cnt = tile(t, p0);
    const bf16* ys = reinterpret_cast<const bf16*>(k12_smem + b * yu) + ((p0 * c) & 7);
    bf16* os = obuf + b * 8 * ou + ((p0 * OC) & 7);
    for (int p = tid; p < cnt; p += 2 * K12_THREADS) {
      const bool two = p + K12_THREADS < cnt;
      const bf16* ya = ys + p * c;
      const bf16* yb = two ? ya + K12_THREADS * c : ya;
      float acc[2][OC] = {};
      // channel ch of both pixels into their sums
      auto channel = [&](int ch, float za, float zb) {
        float r[RS];
#pragma unroll
        for (int j = 0; j < RS; j += 4) {
          const float4 f = *reinterpret_cast<const float4*>(rec + ch * RS + j);
          r[j] = f.x;
          r[j + 1] = f.y;
          r[j + 2] = f.z;
          r[j + 3] = f.w;
        }
        float z[2] = {za, zb};
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if constexpr (PRO) {
            const float a = affine(z[u], r[0], r[1]);
            z[u] = bf2f(f2bf(a > 0.f ? a : 0.f));
          }
#pragma unroll
          for (int k = 0; k < OC; ++k) acc[u][k] = fmaf(z[u], r[W0 + k], acc[u][k]);
        }
      };
      if ((c & 7) == 0) {
        // the lanes' pixels lie 2c bytes apart: at c = 16, 32, 48, 64 a
        // warp's 2-byte reads of one channel fall on 2 to 8 of the 32
        // banks (tools/k12_widths.py), so a pixel's channels are read
        // eight at a time, as 16-byte units (c % 8 == 0: the units are
        // the staged tile's own); the same values, in the same order
        for (int c8 = 0; c8 < c; c8 += 8) {
          float fa[8], fb[8];
          unpack8(*reinterpret_cast<const uint4*>(ya + c8), fa);
          unpack8(*reinterpret_cast<const uint4*>(yb + c8), fb);
#pragma unroll
          for (int j = 0; j < 8; ++j) channel(c8 + j, fa[j], fb[j]);
        }
      } else {
        for (int ch = 0; ch < c; ++ch) channel(ch, bf2f(ya[ch]), bf2f(yb[ch]));
      }
#pragma unroll
      for (int k = 0; k < OC; ++k) {
        os[p * OC + k] = f2bf(__fadd_rn(acc[0][k], bias[k]));
        if (two) os[(p + K12_THREADS) * OC + k] = f2bf(__fadd_rn(acc[1][k], bias[k]));
      }
    }
  }
  __syncthreads();
  if (t > first) store(t - bpg, b ^ 1);
}

// ---- the affine + ReLU backward (K8, K12) and K11's backward: persistent
// blocks over staged tiles

// channels of the cotangent a pixel: the logits' OC (K12), or dz's c (K8)
template <int OC>
__host__ __device__ __forceinline__ int cot_channels(int c) {
  return OC > 0 ? OC : c;
}

// pixels of a tile: K12_TILE_BYTES of y (c channels) and the cotangent (k
// channels), a multiple of 8
__host__ __device__ __forceinline__ int bwd_tile(int c, int k) {
  const int t = (K12_TILE_BYTES / (2 * (c + k))) & ~7;
  return t < 8 ? 8 : t;
}

// entries of a block's partial row: [dwo (c*OC), dbo (OC)], then with the
// prologue [dscale (c), dshift (c)] (at OC = 0, K8, dscale and dshift
// alone, each in its own partial array)
template <bool PRO, int OC>
__host__ __device__ __forceinline__ int bwd_row(int c) {
  return c * OC + OC + (PRO ? 2 * c : 0);
}

// block K12_THREADS; grid groups * bpg, block b of group b / bpg taking
// the group's tiles b % bpg, + bpg, ...  Partial row of a block
// (bwd_row), in partial; at OC = 0 (K8) dscale in partial and dshift in
// partial2, c each.  gout: the logits' cotangent (K12, K11) or dz (K8).
// PRO false (K11): y is z, dy is dz = sum over j of wo[c, j] * g[j], an
// FMA chain in j order from +0, rounded once; sc and sh are not read.
// vec: gout, y and dy are 16-byte aligned.
template <bool PRO, int OC>
__global__ void __launch_bounds__(K12_THREADS, K12_PER_SM) affine_bwd_kernel(
    const bf16* __restrict__ gout, const bf16* __restrict__ y,
    const float* __restrict__ sc, const float* __restrict__ sh,
    const bf16* __restrict__ wo, bf16* __restrict__ dy,
    float* __restrict__ partial, float* __restrict__ partial2, int64_t pixels,
    int64_t gp, int c, int bpg, int vec) {
  extern __shared__ uint4 k12_smem[];
  constexpr int W = OC > 0 ? OC : 1;  // out-conv arrays (unused at OC = 0)
  const int tid = threadIdx.x;
  const int k = cot_channels<OC>(c);
  const int tp = bwd_tile(c, k);
  const int yu = units_of(tp, c), gu = units_of(tp, k);
  const int grp = blockIdx.x / bpg;
  const int64_t ntiles = (gp + tp - 1) / tp;
  const int64_t first = blockIdx.x - (int64_t)grp * bpg;
  const int ns = K12_THREADS / c;  // pixel slices
  const int sl = tid / c, ch = tid - sl * c;
  const bool live = sl < ns;

  float w[W], dwo[W], dbo[W];
  float scv = 0.f, shv = 0.f, s = 0.f, q = 0.f;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    w[j] = live && OC > 0 ? bf2f(wo[((int64_t)grp * c + ch) * OC + j]) : 0.f;
    dwo[j] = dbo[j] = 0.f;
  }
  if (PRO && live) {
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
    stage_units(ybuf(b), y, p0 * c, (p0 + cnt) * c, pixels * c, vec, tid, K12_THREADS);
    stage_units(gbuf(b), gout, p0 * k, (p0 + cnt) * k, pixels * k, vec, tid, K12_THREADS);
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
    const bf16* gs = gbuf(b) + ((p0 * k) & 7);
    if (live)
      for (int p = sl; p < cnt; p += ns) {
        bf16* yp = ys + p * c + ch;
        const float yv = bf2f(*yp);
        const float a = PRO ? affine(yv, scv, shv) : 0.f;
        float dz = 0.f;
        if constexpr (OC == 0) {
          dz = bf2f(gs[p * c + ch]);
        } else {
          float gk[OC];
          if constexpr (OC % 2 == 0) {
#pragma unroll
            for (int j = 0; j < OC; j += 2) load_bf16<2>(gs + p * OC + j, gk + j);
          } else {
#pragma unroll
            for (int j = 0; j < OC; ++j) gk[j] = bf2f(gs[p * OC + j]);
          }
          const float z = PRO ? bf2f(f2bf(a > 0.f ? a : 0.f)) : yv;
#pragma unroll
          for (int j = 0; j < OC; ++j) {
            dz = fmaf(w[j], gk[j], dz);
            dwo[j] = fmaf(z, gk[j], dwo[j]);
          }
          if (ch == 0)
#pragma unroll
            for (int j = 0; j < OC; ++j) dbo[j] += gk[j];
        }
        if constexpr (PRO) {
          const float da = a > 0.f ? dz : 0.f;
          *yp = f2bf(__fmul_rn(da, scv));  // dy in place of y
          s = fmaf(da, yv, s);
          q += da;
        } else {
          *yp = f2bf(dz);  // dz in place of z
        }
      }
    __syncthreads();
    store_units(dy, ybuf(b), p0 * c, (p0 + cnt) * c, vec, tid, K12_THREADS);
  }
  __syncthreads();  // the tiles' buffers become the slices' sums

  // each output's ns slice sums in order
  float* red = reinterpret_cast<float*>(k12_smem);
  const int co = c * OC + OC;  // dwo and dbo's entries
  const int L = bwd_row<PRO, OC>(c);
  if (live) {
    if constexpr (OC > 0) {
#pragma unroll
      for (int j = 0; j < OC; ++j) red[(ch * OC + j) * ns + sl] = dwo[j];
      if (ch == 0)
#pragma unroll
        for (int j = 0; j < OC; ++j) red[(c * OC + j) * ns + sl] = dbo[j];
    }
    if constexpr (PRO) {
      red[(co + ch) * ns + sl] = s;
      red[(co + c + ch) * ns + sl] = q;
    }
  }
  __syncthreads();
  for (int l = tid; l < L; l += K12_THREADS) {
    float v = 0.f;
    for (int r = 0; r < ns; ++r) v += red[l * ns + r];
    if (OC > 0)
      partial[(int64_t)blockIdx.x * L + l] = v;
    else if (l < c)
      partial[(int64_t)blockIdx.x * c + l] = v;
    else
      partial2[(int64_t)blockIdx.x * c + l - c] = v;
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

// blocks a group of a launch of persistent blocks over tiles of tp
// pixels: blocks over the groups, at least one, and at most one per
// K12_MIN_TILES of the group's tiles (the staged backward's are mirrored
// by kernels/train_elem.py prelu_bwd_blocks)
int64_t group_blocks(int64_t gp, int tp, int blocks, int64_t groups) {
  const int64_t tiles = (gp + tp - 1) / tp;
  const int64_t most = (tiles + K12_MIN_TILES - 1) / K12_MIN_TILES;
  const int64_t per = blocks / groups > 0 ? blocks / groups : 1;
  return per < most ? per : most;
}

// shared memory of the staged backward: two tiles' buffers, or the
// slices' sums
template <bool PRO, int OC>
size_t bwd_smem(int c) {
  const int k = cot_channels<OC>(c);
  const int tp = bwd_tile(c, k);
  const size_t tiles = 2 * 16 * (size_t)(units_of(tp, c) + units_of(tp, k));
  const size_t sums = 4 * (size_t)bwd_row<PRO, OC>(c) * (K12_THREADS / c);
  return tiles > sums ? tiles : sums;
}

template <bool PRO, int OC>
int bwd_launch(const void* g, const void* y, const void* sc, const void* sh,
               const void* wo, void* dy, void* partial, void* partial2, int64_t n,
               int64_t hw, int c, int64_t groups, cudaStream_t stream) {
  const int64_t gp = n / groups * hw;
  const int64_t bpg = group_blocks(gp, bwd_tile(c, cot_channels<OC>(c)), K12_BLOCKS, groups);
  affine_bwd_kernel<PRO, OC><<<(unsigned)(groups * bpg), K12_THREADS, bwd_smem<PRO, OC>(c),
                               stream>>>(
      (const bf16*)g, (const bf16*)y, (const float*)sc, (const float*)sh, (const bf16*)wo,
      (bf16*)dy, (float*)partial, (float*)partial2, n * hw, gp, c, (int)bpg,
      (int)aligned16(g, y, dy));
  return (int)cudaGetLastError();
}

template <class Op>
int chunk_launch(const void* dy, const void* y, const void* p, const void* q, void* out,
                 int64_t n, int64_t hw, int64_t o, int64_t groups, void* stream) {
  if (n <= 0 || hw <= 0 || o <= 0 || groups <= 0 || n % groups) return bad();
  const int64_t total = n * hw * o;
  const int64_t blocks = (total + GE_SPAN - 1) / GE_SPAN;
  if (blocks > 0x7fffffff || groups * o > 0x7fffffff) return bad();
  chunk_kernel<Op><<<(unsigned)blocks, GE_THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)dy, (const bf16*)y, (const float*)p, (const float*)q, (bf16*)out,
      total, n / groups * hw * o, (int)o, (int)groups,
      (int)aligned16(Op::DY ? dy : y, y, out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mimo_g_eff(const void* dy, const void* y, const void* dsum,
                          const void* dsumsq, void* out, int64_t n, int64_t hw,
                          int64_t o, int64_t groups, void* stream) {
  return chunk_launch<g_eff_op>(dy, y, dsum, dsumsq, out, n, hw, o, groups, stream);
}

extern "C" int mimo_affine_relu(const void* y, const void* sc, const void* sh,
                                void* z, int64_t n, int64_t hw, int64_t c,
                                int64_t groups, void* stream) {
  return chunk_launch<affine_relu_op>(nullptr, y, sc, sh, z, n, hw, c, groups, stream);
}

// pdsc, pdsh: the partial rows of dscale and dshift, c each, one a block
// (kernels/train_elem.py affine_relu_bwd_blocks)
extern "C" int mimo_affine_relu_bwd(const void* dz, const void* y, const void* sc,
                                    const void* sh, void* dy, void* pdsc,
                                    void* pdsh, int64_t n, int64_t hw, int64_t c,
                                    int64_t groups, void* stream) {
  if (n <= 0 || hw <= 0 || c <= 0 || c > K12_THREADS || groups <= 0 || n % groups ||
      groups > 0x7fffffff / K12_BLOCKS)
    return bad();
  return bwd_launch<true, 0>(dz, y, sc, sh, nullptr, dy, pdsc, pdsh, n, hw, (int)c, groups,
                             (cudaStream_t)stream);
}

namespace {

bool bad_1x1(int64_t n, int64_t hw, int64_t c, int64_t oc, int64_t groups) {
  return n <= 0 || hw <= 0 || c <= 0 || c > CMAX || oc <= 0 || oc > OCMAX ||
         groups <= 0 || n % groups;
}

template <bool PRO, int OC>
int fwd_launch(const void* y, const void* sc, const void* sh, const void* wo, const void* bo,
               void* out, int64_t n, int64_t hw, int c, int64_t groups, cudaStream_t stream) {
  const int64_t gp = n / groups * hw;
  const int tp = fwd_tile(c, OC);
  const int64_t bpg = group_blocks(gp, tp, K12F_BLOCKS, groups);
  const size_t smem = 16 * (size_t)(2 * units_of(tp, c) + 2 * units_of(tp, OC)) +
                      4 * (size_t)c * fwd_record<PRO, OC>();
  cudaFuncSetAttribute(conv1x1_kernel<PRO, OC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  conv1x1_kernel<PRO, OC><<<(unsigned)(groups * bpg), K12_THREADS, smem, stream>>>(
      (const bf16*)y, (const float*)sc, (const float*)sh, (const bf16*)wo, (const float*)bo,
      (bf16*)out, n * hw, gp, c, (int)bpg, (int)aligned16(y, out, y));
  return (int)cudaGetLastError();
}

template <bool PRO>
int conv1x1_launch(const void* y, const void* sc, const void* sh, const void* wo,
                   const void* bo, void* out, int64_t n, int64_t hw, int64_t c,
                   int64_t oc, int64_t groups, void* stream) {
  if (bad_1x1(n, hw, c, oc, groups) || groups > 0x7fffffff / K12F_BLOCKS) return bad();
  const cudaStream_t st = (cudaStream_t)stream;
  const int ci = (int)c;
  switch (oc) {
    case 1: return fwd_launch<PRO, 1>(y, sc, sh, wo, bo, out, n, hw, ci, groups, st);
    case 2: return fwd_launch<PRO, 2>(y, sc, sh, wo, bo, out, n, hw, ci, groups, st);
    case 3: return fwd_launch<PRO, 3>(y, sc, sh, wo, bo, out, n, hw, ci, groups, st);
    case 4: return fwd_launch<PRO, 4>(y, sc, sh, wo, bo, out, n, hw, ci, groups, st);
    case 5: return fwd_launch<PRO, 5>(y, sc, sh, wo, bo, out, n, hw, ci, groups, st);
    case 6: return fwd_launch<PRO, 6>(y, sc, sh, wo, bo, out, n, hw, ci, groups, st);
    case 7: return fwd_launch<PRO, 7>(y, sc, sh, wo, bo, out, n, hw, ci, groups, st);
    default: return fwd_launch<PRO, 8>(y, sc, sh, wo, bo, out, n, hw, ci, groups, st);
  }
}

// the 1x1 backward, K12's (PRO) or K11's, at oc out-conv channels
template <bool PRO>
int conv1x1_bwd_launch(const void* g, const void* y, const void* sc, const void* sh,
                       const void* wo, void* dy, void* partial, int64_t n, int64_t hw,
                       int64_t c, int64_t oc, int64_t groups, void* stream) {
  if (bad_1x1(n, hw, c, oc, groups) || groups > 0x7fffffff / K12_BLOCKS) return bad();
  const cudaStream_t st = (cudaStream_t)stream;
  const int ci = (int)c;
  switch (oc) {
    case 1: return bwd_launch<PRO, 1>(g, y, sc, sh, wo, dy, partial, nullptr, n, hw, ci, groups, st);
    case 2: return bwd_launch<PRO, 2>(g, y, sc, sh, wo, dy, partial, nullptr, n, hw, ci, groups, st);
    case 3: return bwd_launch<PRO, 3>(g, y, sc, sh, wo, dy, partial, nullptr, n, hw, ci, groups, st);
    case 4: return bwd_launch<PRO, 4>(g, y, sc, sh, wo, dy, partial, nullptr, n, hw, ci, groups, st);
    case 5: return bwd_launch<PRO, 5>(g, y, sc, sh, wo, dy, partial, nullptr, n, hw, ci, groups, st);
    case 6: return bwd_launch<PRO, 6>(g, y, sc, sh, wo, dy, partial, nullptr, n, hw, ci, groups, st);
    case 7: return bwd_launch<PRO, 7>(g, y, sc, sh, wo, dy, partial, nullptr, n, hw, ci, groups, st);
    default: return bwd_launch<PRO, 8>(g, y, sc, sh, wo, dy, partial, nullptr, n, hw, ci, groups, st);
  }
}

}  // namespace

extern "C" int mimo_conv1x1_prelu(const void* y, const void* sc, const void* sh,
                                  const void* wo, const void* bo, void* out,
                                  int64_t n, int64_t hw, int64_t c, int64_t oc,
                                  int64_t groups, void* stream) {
  return conv1x1_launch<true>(y, sc, sh, wo, bo, out, n, hw, c, oc, groups,
                              stream);
}

// partial: one row of bwd_row<true, OC> a block (kernels/train_elem.py
// prelu_bwd_blocks)
extern "C" int mimo_conv1x1_prelu_bwd(const void* g, const void* y,
                                      const void* sc, const void* sh,
                                      const void* wo, void* dy, void* partial,
                                      int64_t n, int64_t hw, int64_t c,
                                      int64_t oc, int64_t groups, void* stream) {
  return conv1x1_bwd_launch<true>(g, y, sc, sh, wo, dy, partial, n, hw, c, oc, groups, stream);
}

extern "C" int mimo_conv1x1(const void* z, const void* wo, const void* bo,
                            void* out, int64_t n, int64_t hw, int64_t c,
                            int64_t oc, int64_t groups, void* stream) {
  return conv1x1_launch<false>(z, nullptr, nullptr, wo, bo, out, n, hw, c, oc,
                               groups, stream);
}

// partial: one row of bwd_row<false, OC> a block (kernels/train_elem.py
// conv1x1_bwd_blocks)
extern "C" int mimo_conv1x1_bwd(const void* g, const void* z, const void* wo,
                                void* dz, void* partial, int64_t n, int64_t hw,
                                int64_t c, int64_t oc, int64_t groups,
                                void* stream) {
  return conv1x1_bwd_launch<false>(g, z, nullptr, nullptr, wo, dz, partial, n, hw, c, oc,
                                   groups, stream);
}

extern "C" int mimo_reduce_groups(const void* partial, void* out, int64_t groups,
                                  int64_t p, int64_t l, void* stream) {
  if (groups <= 0 || groups > 65535 || p <= 0 || l <= 0) return bad();
  const dim3 grid((unsigned)((l + 31) / 32), (unsigned)groups);
  reduce_groups_kernel<<<grid, dim3(32, 16), 0, (cudaStream_t)stream>>>(
      (const float*)partial, (float*)out, p, l);
  return (int)cudaGetLastError();
}
