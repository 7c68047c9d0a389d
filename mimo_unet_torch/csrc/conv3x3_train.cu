// Train-mode 3x3 reflect conv per subnetwork group, channels-last bf16, and
// its two backward kernels:
//   * mimo_conv3x3_fwd (K5): y = conv(z), z = x or relu(x*scale+shift) (the
//     previous BatchNorm's affine as a prologue); y rounded to bf16, no
//     bias; per-channel sum and sum of squares of the *rounded* y, per
//     block (the wrapper reduces them per group).  Optional second concat
//     input x2 whose image n is x2 image n % n2; with x2_half_h it arrives
//     at half height, W-upsampled (upsample_w2x.cu), and the staging lerps
//     its rows (below).
//     Replaces mimo_unet_tpu/ops/pallas/ct_train.py:283 _conv_fwd
//     (pallas_call :318), reached through conv3x3_ct_train :1099.
//   * mimo_conv3x3_dx (K6): dz = transpose of (reflect pad + conv) applied
//     to g; without x2, optionally the prologue backward fused in
//     (da = dz*[a>0], dx = da*scale, per-block dscale += da*x, dshift +=
//     da); with x2 (the fold form) each block loops over the S images that
//     share one x2 image and sums their bf16-rounded x2 cotangents in f32.
//     Replaces ct_train.py:579 _conv_dx (pallas_call :648) and :677
//     _conv_dx_fold_call (:697).
//   * mimo_conv3x3_dw (K7): per-block partial dw over a chunk of one
//     group's pixels, the recomputed z contracted with g (the wrapper
//     reduces the chunks), x2_half_h as in the forward.  Replaces
//     ct_train.py:815 _conv_dw (pallas_call :853).
//
// Padding and rounding, as the TPU kernels do them:
//   * fwd and dw read x at reflect(i + dy - 1), reflect(j + dx - 1); with
//     x2_half_h (ct_train.py:238 _x2_half_spec, :255 _stage_x2_half) the
//     x2 value of full row r is bf16(a * fa[r] + b * fb[r]) from half rows
//     a = lo[r] and b = lo[r] + 1, no FMA: the tables and the operation
//     order of the x2 upsample's H lerp (upsample2x.cu), so y, its
//     statistics and dw are bit for bit those of the full-res x2 that the
//     upsample would have written;
//   * dx is the zero-pad full conv of g with the transposed taps plus the
//     additive reflect folds (ct_train.py:26-31): pixel row 1 also takes g
//     row 0 through tap dy = 0 and row H-2 takes g row H-1 through dy = 2
//     (the same for columns).
//   * bf16 operands, f32 accumulation, the prologue z computed in f32 and
//     rounded to bf16 before the product (ct_train.py:151-156), statistics
//     of the bf16 y (:220-224), dx rounded once, the fold's per-image
//     cotangents rounded before their f32 sum.
//
// What bounds them on the H100: arithmetic.  Per output pixel the products
// are 9*Cin*O multiply-adds (Cin, O = 3..63), against a few hundred bytes
// in and out, so at these channel counts the work sits above the memory
// roofline.
//
// All three run on the tensor cores (mma.sync m16n8k16, bf16 operands, f32
// accumulators, fed by ldmatrix) from tiles staged once in shared memory.
// A block works through spatial tiles of 16 columns by th rows (th = 8
// unless the channels need the room) of one image, each with a one-pixel
// halo.  A tile's rows arrive as flat runs of the [N, H, W, C] tensor (a
// run of pixels of one image row is contiguous) in 16-byte cp.async
// copies, the next tile's while the tensor cores work on this one; a
// repack pass then writes the tile in bf16 [pixel][channel] with the
// channels padded in shared memory to the mma multiple (and a row stride
// of an odd number of 16-byte units, so that ldmatrix's eight rows fall in
// eight bank groups):
//   * K5 and K7 stage z with one pair of functions (z_fetch, z_repack): the
//     reflect applied at the image edges, the prologue affine and the
//     x2_half_h lerp once per staged element, channels in slices of at most
//     64.  At cin <= 7 (the RGB input conv) the staging folds (tap,
//     channel) into one dimension of 9*cin padded to 16 (27 -> 32) over the
//     tile's own pixels.
//   * K5 also stages its group's weights [9, cin, o-slice] (packed by the
//     wrapper).  Eight warps, one per tile row: D[16 pixels x o-slice] +=
//     Z_t . W_t over the taps and 16-channel k-steps, Z_t the staged tile
//     shifted by the tap (im2col: the k-steps of the folded pairs).  A cin
//     wider than one slice is restaged slice by slice inside the block, so
//     the whole f32 sum exists before y's one rounding.  The epilogue
//     rounds y, stores it and sums the rounded values and their squares
//     per channel in registers over the block's tiles.
//   * K7 also stages g [pixels, o-slice].  Nine warps, one per tap:
//     D[cin x o] += Z_t^T . G over each 16-pixel row of the tile, so a
//     warp's accumulators (up to 4 x 4 mma tiles: 64 channels by 32
//     outputs, the launch's slices) stay in registers; at cin <= 7 warps own
//     tiles of the folded M instead.
//   * K6 stages g with a zero halo and its group's weights [9, cin-slice,
//     o] (packed by the wrapper).  Eight warps, one per tile row: D[16
//     pixels x cin-slice] += G_t . W_t over the taps and o.  Each reflect
//     fold is one more mma step with the same tap's weights, its A rows
//     the mirrored tap's view of the staged g (the single edge value) and
//     the rows it does not reach pointed at a zero row: products stay
//     exact, sums f32.  Tiles that touch no fold row or column skip them.
// Reductions across blocks (statistics, dscale, dshift, dw) go to
// per-block partials that a second pass sums per group in a fixed order;
// inside a block, lanes by shuffles and warps in order through shared
// memory: results do not change from run to run.
#include "common.cuh"
#include "ptx.cuh"

namespace {

// relu(x*scale + shift) rounded to bf16, as the prologue z
__device__ __forceinline__ float prologue_z(float x, float s, float b) {
  return bf2f(f2bf(relu(__fadd_rn(__fmul_rn(x, s), b))));
}

constexpr int TW = 16;              // tile columns: a dw k-step, a fwd/dx m-tile
constexpr int HWD = TW + 2;         // halo tile columns
constexpr int FWD_THREADS = 256;    // eight warps, one per tile row
constexpr int DW_THREADS = 288;     // nine warps, one per tap
constexpr int DX_THREADS = 256;     // eight warps, one per tile row
constexpr int CS_MAX = 64;          // channels of a staged z slice of K5
constexpr int NT_FWD = 8;           // fwd mma n-tiles per warp: 64 outputs
constexpr int MT_DW = 4, NT_DW = 4; // dw mma tiles per warp: 64 ch x 32 outputs
constexpr int NT_DX = 8;            // dx mma n-tiles per warp: 64 channels
constexpr int SMEM_MAX = 232448;    // dynamic shared memory of one block

// where the prologue's shift starts in the staged affine table [scale |
// shift], each part c1 floats padded to 8, so eight channels from any
// multiple of 8 load as two 16-byte units of each
__host__ __device__ __forceinline__ int shift_at(int c1) { return (c1 + 7) & ~7; }

struct TcConv {
  const bf16* x1;     // fwd, dw: [n, h, w, c1]; dx: the prologue's x1 or null
  const bf16* x2;     // fwd, dw: [n2, h, w, c2] ([n2, h/2, w, c2] with x2_half_h)
  const bf16* g;      // [n, h, w, o]
  const bf16* wpk;    // packed weights: fwd [G, nos, 9*ncs*cb or mp, ws]; dx [G, ncs, 9, cb, ws]
  const float* sc;    // [G, c1] prologue scale, or null
  const float* sh;
  const int* frow;    // dx: fold bits of each image row (bit 0: g row 0
  const int* fcol;    //   through dy = 0; bit 1: row h-1 through dy = 2); columns
  const int* lo;      // x2_half_h: first half row of full row r, weights
  const float* fa;
  const float* fb;
  bf16* y;            // fwd: y [n, h, w, o]; dx: dx1 [n, h, w, c1]
  bf16* y2;           // dx fold: dx2 [n2, h, w, c2]
  float* p0;          // fwd per-block sum; dw partials; dx per-block dscale
  float* p1;          // fwd per-block sum of squares; dx per-block dshift
  int n, h, w, c1, c2, n2, o, groups, prologue;
  int th, tiles_w, tpi, per;   // tile rows; tile columns and tiles per image; images per group
  int cb, ncs;                 // channel slice (padded width) and slices
  int nb, nos;                 // fwd, dw: output slice (padded width) and slices
  int im2col, mp;              // fwd, dw: (tap, channel) folded into K (M), its padded width
  int span, chunks;            // dw: tiles per chunk, chunks per group; fwd, dx: tiles per block, blocks per image
  int opad;                    // dx: o padded to 16
  int zs, gs, ws;              // row strides (elements): z / A tile, g tile, weights
  int r1, r2, rg;              // raw bytes per row: x1, x2 (per half row), g
  int o_z, o_g, o_w, o_r1, o_r2, o_rg, o_info, o_aff, o_red, o_zero, smem;  // byte offsets
};

struct TileAt {
  int img, r0, c0;  // image; first row and column (the halo starts one before)
};

__device__ __forceinline__ TileAt tile_at(const TcConv& p, int img, int t) {
  const int tr = t / p.tiles_w;
  return TileAt{img, tr * p.th, (t - tr * p.tiles_w) * TW};
}

// cp.async the flat run of elements [s0, s1) of ``base`` (16-byte aligned)
// into dst in 16-byte units, a warp's lanes taking every 32nd; the run's
// element offset within its first unit goes to *slot
__device__ __forceinline__ void copy_run(uint8_t* dst, const bf16* base, int64_t s0,
                                         int64_t s1, int* slot, int lane) {
  const int64_t q0 = s0 >> 3;
  const int n = (int)(((s1 + 7) >> 3) - q0);
  for (int k = lane; k < n; k += 32) cp_async16(dst + k * 16, base + ((q0 + k) << 3));
  if (lane == 0) *slot = (int)(s0 - (q0 << 3));
}

// ---- z staging, shared by K5 and K7: the raw runs of a tile's halo rows
// (x1; x2 or its two half rows), one run a warp at a time over nw warps.
// info: [th + 2][4] run offsets of x1, x2 (a, b).
template <bool X2H>
__device__ void z_fetch(const TcConv& p, uint8_t* sm, TileAt tl, int warp, int nw,
                        int lane) {
  const int H = p.h, W = p.w, rows = p.th + 2;
  const int lo = max(tl.c0 - 1, 0), hi = min(tl.c0 + TW + 1, W);
  int* info = (int*)(sm + p.o_info);
  const int nsrc = p.c2 > 0 ? (X2H ? 3 : 2) : 1;
  for (int rs = warp; rs < rows * nsrc; rs += nw) {
    const int hr = rs / nsrc, src = rs - hr * nsrc, sr = tl.r0 - 1 + hr;
    if (sr > H) continue;  // only pixels below the image read this row
    const int rr = reflect(sr, H);
    if (src == 0) {
      const int64_t st = ((int64_t)tl.img * H + rr) * W;
      copy_run(sm + p.o_r1 + hr * p.r1, p.x1, (st + lo) * p.c1, (st + hi) * p.c1,
               info + hr * 4, lane);
    } else {
      const int i2 = tl.img % p.n2;
      int64_t st;
      if constexpr (X2H)
        st = ((int64_t)i2 * (H / 2) + p.lo[rr] + (src - 1)) * W;
      else
        st = ((int64_t)i2 * H + rr) * W;
      copy_run(sm + p.o_r2 + (hr * 2 + src - 1) * p.r2, p.x2, (st + lo) * p.c2,
               (st + hi) * p.c2, info + hr * 4 + src, lane);
    }
  }
}

// Where halo position (hr, hc) of the tile reads z: the staged runs at its
// reflected source pixel (x1; x2, or x2's two half rows and the lerp
// weights of the full row), or nothing (only pixels outside the image
// read it).  Resolved once per position, then read for each channel.
template <bool X2H>
struct ZSrc {
  const bf16* a;   // the pixel's x1 channels
  const bf16* b;   // its x2 channels (X2H: of half row lo)
  const bf16* b2;  // X2H: of half row lo + 1
  float fa, fb;
  bool live;
};

template <bool X2H>
__device__ __forceinline__ ZSrc<X2H> z_src(const TcConv& p, const uint8_t* sm,
                                          const int* info, TileAt tl, int hr, int hc) {
  ZSrc<X2H> z = {};
  const int sr = tl.r0 - 1 + hr, scol = tl.c0 - 1 + hc;
  z.live = sr <= p.h && scol <= p.w;
  if (!z.live) return z;
  const int s = reflect(scol, p.w) - max(tl.c0 - 1, 0);
  z.a = (const bf16*)(sm + p.o_r1 + hr * p.r1) + info[hr * 4] + s * p.c1;
  if (p.c2 > 0) {
    z.b = (const bf16*)(sm + p.o_r2 + hr * 2 * p.r2) + info[hr * 4 + 1] + s * p.c2;
    if constexpr (X2H) {
      z.b2 = (const bf16*)(sm + p.o_r2 + (hr * 2 + 1) * p.r2) + info[hr * 4 + 2] +
             s * p.c2;
      const int rr = reflect(sr, p.h);
      z.fa = p.fa[rr];
      z.fb = p.fb[rr];
    }
  }
  return z;
}

// z channel c (< cin) of the concat at a live position: the prologue
// (aff: the group's scale and shift, stage_affine) or the H lerp applied
template <bool X2H>
__device__ __forceinline__ float z_val(const TcConv& p, const ZSrc<X2H>& z,
                                       const float* aff, int c) {
  if (c < p.c1) {
    const float v = bf2f(z.a[c]);
    return p.prologue ? prologue_z(v, aff[c], aff[shift_at(p.c1) + c]) : v;
  }
  const float va = bf2f(z.b[c - p.c1]);
  if constexpr (X2H)
    return bf2f(f2bf(__fadd_rn(__fmul_rn(va, z.fa), __fmul_rn(bf2f(z.b2[c - p.c1]), z.fb))));
  return va;
}

// The staged z from the raw runs, by NTH threads: [(th+2) x 18 halo
// positions][cb] of channels [cs0, cs0 + cs_n), eight channels a work item
// (a thread keeps its 8-channel group q); im2col: [th*16 pixels][mp],
// column t*cin + c, a work item a (pixel, tap), the columns past 9*cin
// left as z_pad wrote them
template <bool X2H, int NTH>
__device__ void z_repack(const TcConv& p, uint8_t* sm, TileAt tl, int cs0, int cs_n,
                         int tid) {
  const int* info = (const int*)(sm + p.o_info);
  const float* aff = (const float*)(sm + p.o_aff);
  bf16* Z = (bf16*)(sm + p.o_z);
  const int cin = p.c1 + p.c2;
  const uint4 zero = {0u, 0u, 0u, 0u};
  if (!p.im2col) {
    const int q8 = p.cb / 8, per = NTH / q8, q = tid % q8;
    const int k0 = 8 * q, c0 = cs0 + k0, n = min(8, cs_n - k0);
    // bit copies: x1 without the prologue, x2 without the lerp
    const bool copy = !p.prologue && (c0 + n <= p.c1 || (!X2H && c0 >= p.c1));
    const int end = (p.th + 2) * HWD;
    for (int pos = tid < per * q8 ? tid / q8 : end; pos < end; pos += per) {
      const int hr = pos / HWD, hc = pos - hr * HWD;
      bf16* dst = Z + pos * p.zs + k0;
      const ZSrc<X2H> z = z_src<X2H>(p, sm, info, tl, hr, hc);
      if (!z.live || n <= 0) {
        *reinterpret_cast<uint4*>(dst) = zero;
      } else if (copy) {
        *reinterpret_cast<uint4*>(dst) =
            c0 < p.c1 ? ld8(z.a + c0, n) : ld8(z.b + (c0 - p.c1), n);
      } else if (p.prologue) {  // eight x1 channels (the prologue takes no x2)
        float x[8], v[8];
        unpack8(ld8(z.a + c0, n), x);
        const float4* s4 = reinterpret_cast<const float4*>(aff + c0);
        const float4* b4 = reinterpret_cast<const float4*>(aff + shift_at(p.c1) + c0);
        const float4 sa = s4[0], sb = s4[1], ba = b4[0], bb = b4[1];
        const float sv[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
        const float bv[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
#pragma unroll
        for (int j = 0; j < 8; ++j)  // prologue_z, its rounding left to st8
          v[j] = j < n ? relu(__fadd_rn(__fmul_rn(x[j], sv[j]), bv[j])) : 0.f;
        st8(dst, v);
      } else if (X2H && c0 >= p.c1) {  // eight x2 channels lerped from the half rows
        float va[8], vb[8], v[8];
        unpack8(ld8(z.b + (c0 - p.c1), n), va);
        unpack8(ld8(z.b2 + (c0 - p.c1), n), vb);
#pragma unroll
        for (int j = 0; j < 8; ++j)  // z_val's lerp, its rounding left to st8
          v[j] = __fadd_rn(__fmul_rn(va[j], z.fa), __fmul_rn(vb[j], z.fb));
        st8(dst, v);
      } else {
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = j < n ? z_val<X2H>(p, z, aff, c0 + j) : 0.f;
        st8(dst, v);
      }
    }
  } else {
    for (int e = tid; e < p.th * TW * 9; e += NTH) {
      const int t = e % 9, px = e / 9, j = px / TW, x = px - j * TW;
      const int dy = t / 3, dx = t - 3 * dy;
      const ZSrc<X2H> z = z_src<X2H>(p, sm, info, tl, j + dy, x + dx);
      bf16* dst = Z + px * p.zs + t * cin;
      for (int c = 0; c < cin; ++c) dst[c] = f2bf(z.live ? z_val<X2H>(p, z, aff, c) : 0.f);
    }
  }
}

// im2col: the zero columns [9*cin, mp) of the staged z, once a block (no
// repack writes them)
__device__ void z_pad(const TcConv& p, uint8_t* sm, int tid, int nth) {
  if (!p.im2col) return;
  bf16* Z = (bf16*)(sm + p.o_z);
  const int m_n = 9 * (p.c1 + p.c2), pad = p.mp - m_n;
  for (int e = tid; e < p.th * TW * pad; e += nth)
    Z[(e / pad) * p.zs + m_n + e % pad] = f2bf(0.f);
}

// the group's prologue scale and shift [2][shift_at(c1)], for z_repack
__device__ void stage_affine(const TcConv& p, uint8_t* sm, int g, int tid, int nth) {
  float* aff = (float*)(sm + p.o_aff);
  for (int c = tid; c < p.c1; c += nth) {
    aff[c] = p.sc[g * p.c1 + c];
    aff[shift_at(p.c1) + c] = p.sh[g * p.c1 + c];
  }
}

// ---- K5: the group's packed weights of output slice os, [rows][ws] with
// rows 9 * ncs * cb (tap-major) or mp (im2col)
__device__ void fwd_fetch_w(const TcConv& p, uint8_t* sm, int grp, int os, int tid) {
  const int rows = p.im2col ? p.mp : 9 * p.ncs * p.cb;
  const int units = rows * p.ws / 8;  // 16-byte units
  const bf16* src = p.wpk + ((int64_t)grp * p.nos + os) * rows * p.ws;
  for (int e = tid; e < units; e += FWD_THREADS)
    cp_async16(sm + p.o_w + e * 16, src + e * 8);
}

// One k-step: acc[nt] += A . B_nt, A 16 pixels x 16 channels at za (this
// lane's row), B 16 channels x the n-tiles at wb (this lane's row; a pair
// of n-tiles an ldmatrix, the last one alone when ntn is odd)
__device__ __forceinline__ void fwd_step(uint32_t za, uint32_t wb, int ntn,
                                         float acc[NT_FWD][4]) {
  uint32_t bw[NT_FWD][2];
#pragma unroll
  for (int nt = 0; nt < NT_FWD; nt += 2) {
    if (nt >= ntn) continue;
    if (nt + 1 < ntn) {
      uint32_t q[4];
      ldsm_x4_t(q, wb + nt * 16);
      bw[nt][0] = q[0];
      bw[nt][1] = q[1];
      bw[nt + 1][0] = q[2];
      bw[nt + 1][1] = q[3];
    } else {
      ldsm_x2_t(bw[nt], wb + nt * 16);  // lanes 0-15 give the addresses
    }
  }
  uint32_t af[4];
  ldsm_x4(af, za);
#pragma unroll
  for (int nt = 0; nt < NT_FWD; ++nt)
    if (nt < ntn) mma16816(acc[nt], af, bw[nt]);
}

// acc[nt] += Z_t . W_t for the 16 pixels of tile row ``warp`` over the nine
// taps and the k-steps of channel slice cs (im2col: the k-steps of the
// folded (tap, channel) pairs of the warp's own pixels).  sbase: the
// shared-space address of the block's dynamic shared memory.
__device__ __forceinline__ void fwd_compute(const TcConv& p, uint32_t sbase, int warp,
                                            int lane, int cs, int ntn,
                                            float acc[NT_FWD][4]) {
  const int mi = lane >> 3, r = lane & 7;
  const int zs2 = 2 * p.zs, ws2 = 2 * p.ws;  // bytes per staged row
  // this lane's A row: pixel (mi & 1) * 8 + r, channels (mi >> 1) * 8 on;
  // its B row: channel (mi & 1) * 8 + r of a k-step, outputs (mi >> 1) * 8 on
  const int px = (mi & 1) * 8 + r;
  const uint32_t wb = sbase + p.o_w + px * ws2 + (mi >> 1) * 16;
  if (p.im2col) {
    const uint32_t za = sbase + p.o_z + (warp * TW + px) * zs2 + (mi >> 1) * 16;
    for (int k = 0; k < p.mp / 16; ++k) fwd_step(za + 32 * k, wb + 16 * k * ws2, ntn, acc);
    return;
  }
  const uint32_t za = sbase + p.o_z + (warp * HWD + px) * zs2 + (mi >> 1) * 16;
  const uint32_t wc = wb + cs * p.cb * ws2, tapw = p.ncs * p.cb * ws2;
  const int ks = p.cb / 16;
  for (int t = 0; t < 9; ++t) {
    const int dy = t / 3, dx = t - 3 * dy;
    const uint32_t zt = za + (dy * HWD + dx) * zs2, wt = wc + t * tapw;
    for (int k = 0; k < ks; ++k) fwd_step(zt + 32 * k, wt + 16 * k * ws2, ntn, acc);
  }
}

// grid (n * chunks, nos): block (image, tiles [bt * span, +span), output
// slice) writes y at its pixels and outputs, and its row of the per-block
// statistics p0 (sum), p1 (sum of squares) [n * chunks][o]
template <bool X2H>
__global__ void __launch_bounds__(FWD_THREADS, 2) conv_fwd_tc(TcConv p) {
  extern __shared__ __align__(16) uint8_t sm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int img = blockIdx.x / p.chunks, bt = blockIdx.x - img * p.chunks;
  const int os = blockIdx.y, cin = p.c1 + p.c2, g = img / p.per;
  const int os0 = os * p.nb, os_n = min(p.nb, p.o - os0), ntn = (os_n + 7) / 8;
  const int t0 = bt * p.span, t1 = min(t0 + p.span, p.tpi);
  const int nsl = p.im2col ? 1 : p.ncs;  // channel slices staged in turn
  const int gq = lane >> 2, tq = lane & 3;
  float ps[NT_FWD][2] = {}, pq[NT_FWD][2] = {};  // this thread's sums of y, y^2
  if (p.prologue) stage_affine(p, sm, g, tid, FWD_THREADS);
  z_pad(p, sm, tid, FWD_THREADS);
  if (t0 < t1) {
    fwd_fetch_w(p, sm, g, os, tid);
    z_fetch<X2H>(p, sm, tile_at(p, img, t0), warp, FWD_THREADS / 32, lane);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    z_repack<X2H, FWD_THREADS>(p, sm, tile_at(p, img, t0), 0, min(p.cb, cin), tid);
    __syncthreads();
  }
  for (int t = t0; t < t1; ++t) {
    const TileAt tl = tile_at(p, img, t);
    const int a = tl.r0 + warp;  // the warp's image row
    const bool live = warp < p.th && a < p.h;
    const bool more = t + 1 < t1;
    float acc[NT_FWD][4] = {};
    for (int cs = 0; cs < nsl; ++cs) {
      const bool last = cs + 1 == nsl;
      if (last && more) {  // the next tile's runs load while this one multiplies
        z_fetch<X2H>(p, sm, tile_at(p, img, t + 1), warp, FWD_THREADS / 32, lane);
        cp_async_commit();
      }
      if (live) fwd_compute(p, smem_addr(sm), warp, lane, cs, ntn, acc);
      if (last && live) {  // y rounded once; statistics of the rounded values
        bf16* yrow = p.y + ((int64_t)img * p.h + a) * p.w * p.o + os0;
#pragma unroll
        for (int nt = 0; nt < NT_FWD; ++nt) {
          if (nt >= ntn) continue;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = tl.c0 + gq + (i >> 1) * 8, n = nt * 8 + 2 * tq + (i & 1);
            if (col >= p.w || n >= os_n) continue;
            const bf16 v = f2bf(acc[nt][i]);
            yrow[(int64_t)col * p.o + n] = v;
            const float f = bf2f(v);
            ps[nt][i & 1] += f;
            pq[nt][i & 1] = fmaf(f, f, pq[nt][i & 1]);
          }
        }
      }
      cp_async_wait_all();
      __syncthreads();
      if (!last) {  // this tile's next channel slice
        const int c0 = (cs + 1) * p.cb;
        z_repack<X2H, FWD_THREADS>(p, sm, tl, c0, min(p.cb, cin - c0), tid);
        __syncthreads();
      } else if (more) {
        z_repack<X2H, FWD_THREADS>(p, sm, tile_at(p, img, t + 1), 0, min(p.cb, cin), tid);
        __syncthreads();
      }
    }
  }
  // the block's statistics: lanes, then warps, in order
  float* red = (float*)(sm + p.o_red);
#pragma unroll
  for (int nt = 0; nt < NT_FWD; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float vs = ps[nt][j], vq = pq[nt][j];
#pragma unroll
      for (int m = 4; m < 32; m <<= 1) {
        vs += __shfl_xor_sync(0xffffffffu, vs, m);
        vq += __shfl_xor_sync(0xffffffffu, vq, m);
      }
      if (gq == 0 && nt < ntn) {
        red[warp * p.nb + nt * 8 + 2 * tq + j] = vs;
        red[(8 + warp) * p.nb + nt * 8 + 2 * tq + j] = vq;
      }
    }
  __syncthreads();
  for (int c = tid; c < os_n; c += FWD_THREADS) {
    float vs = 0.f, vq = 0.f;
    for (int w = 0; w < 8; ++w) {
      vs += red[w * p.nb + c];
      vq += red[(8 + w) * p.nb + c];
    }
    p.p0[(int64_t)blockIdx.x * p.o + os0 + c] = vs;
    p.p1[(int64_t)blockIdx.x * p.o + os0 + c] = vq;
  }
}

// ---- K7 staging: z's runs (z_fetch), then the tile's g rows continuing the
// warps' round robin.  info: [th + 2][4] as z_fetch, then [th] of g.
template <bool X2H>
__device__ void dw_fetch(const TcConv& p, uint8_t* sm, TileAt tl, int warp, int lane) {
  constexpr int NW = DW_THREADS / 32;
  z_fetch<X2H>(p, sm, tl, warp, NW, lane);
  const int rows = p.th + 2, nz = rows * (p.c2 > 0 ? (X2H ? 3 : 2) : 1);
  const int hig = min(tl.c0 + TW, p.w);
  int* info = (int*)(sm + p.o_info);
  for (int rs = nz + (warp - nz % NW + NW) % NW; rs < nz + p.th; rs += NW) {
    const int j = rs - nz, r = tl.r0 + j;  // g row j
    if (r >= p.h) continue;
    const int64_t st = ((int64_t)tl.img * p.h + r) * p.w;
    copy_run(sm + p.o_rg + j * p.rg, p.g, (st + tl.c0) * p.o, (st + hig) * p.o,
             info + 4 * rows + j, lane);
  }
}

// the staged tiles: z (z_repack) and g [th*16][nb]
template <bool X2H>
__device__ void dw_repack(const TcConv& p, uint8_t* sm, TileAt tl, int cs0,
                          int cs_n, int os0, int os_n, int tid) {
  z_repack<X2H, DW_THREADS>(p, sm, tl, cs0, cs_n, tid);
  const int* info = (const int*)(sm + p.o_info);
  bf16* G = (bf16*)(sm + p.o_g);
  const int q8 = p.nb / 8, per = DW_THREADS / q8, q = tid % q8, rows = p.th + 2;
  const int n = min(8, os_n - 8 * q);
  for (int px = tid / q8; px < p.th * TW; px += per) {
    const int j = px / TW, x = px - j * TW;
    uint4 v = {0u, 0u, 0u, 0u};
    if (n > 0 && tl.r0 + j < p.h && tl.c0 + x < p.w)
      v = ld8((const bf16*)(sm + p.o_rg + j * p.rg) + info[4 * rows + j] + x * p.o +
                  os0 + 8 * q, n);
    *reinterpret_cast<uint4*>(G + px * p.gs + 8 * q) = v;
  }
}

// One tile's products: each 16-pixel row j of the tile is a k-step;
// acc[mt][nt] += A (16 channels of M tile mt) . G (8 outputs of n-tile nt).
// sbase: the shared-space address of the block's dynamic shared memory.
__device__ __forceinline__ void dw_compute(const TcConv& p, uint32_t sbase, int warp,
                                           int lane, int mt_lo, int mt_hi, int ntn,
                                           float acc[MT_DW][NT_DW][4]) {
  const int mi = lane >> 3, r = lane & 7;
  // A rows: pixels; im2col: the tile's own, else tap ``warp``'s view of the
  // halo tile.  Lane: pixel (mi >> 1) * 8 + r, channels (mi & 1) * 8 on.
  int rowp = TW * p.zs, toff = 0;
  if (!p.im2col) {
    const int dy = warp / 3, dx = warp - 3 * dy;
    rowp = HWD * p.zs;
    toff = (dy * HWD + dx) * p.zs;
  }
  const uint32_t za = sbase + p.o_z + 2 * (toff + ((mi >> 1) * 8 + r) * p.zs + (mi & 1) * 8);
  // B rows: pixels (mi & 1) * 8 + r of the g tile, outputs (mi >> 1) * 8 on
  const uint32_t gb = sbase + p.o_g + 2 * (((mi & 1) * 8 + r) * p.gs + (mi >> 1) * 8);
  const uint32_t gb2 = sbase + p.o_g + 2 * (((mi & 1) * 8 + r) * p.gs);
  for (int j = 0; j < p.th; ++j) {
    uint32_t b[NT_DW][2];
    const uint32_t gj = 2 * j * TW * p.gs;
#pragma unroll
    for (int nt = 0; nt < NT_DW; nt += 2) {
      if (nt >= ntn) continue;
      if (nt + 1 < ntn) {
        uint32_t q[4];
        ldsm_x4_t(q, gb + gj + nt * 16);
        b[nt][0] = q[0];
        b[nt][1] = q[1];
        b[nt + 1][0] = q[2];
        b[nt + 1][1] = q[3];
      } else {
        ldsm_x2_t(b[nt], gb2 + gj + nt * 16);
      }
    }
    const uint32_t zj = za + 2 * j * rowp;
#pragma unroll
    for (int mt = 0; mt < MT_DW; ++mt) {
      if (mt < mt_lo || mt >= mt_hi) continue;
      uint32_t a[4];
      ldsm_x4_t(a, zj + mt * 32);
#pragma unroll
      for (int nt = 0; nt < NT_DW; ++nt)
        if (nt < ntn) mma16816(acc[mt][nt], a, b[nt]);
    }
  }
}

// grid (chunks, ncs * nos, groups): block (chunk, slice, g) sums tiles
// [chunk * span, +span) of group g's images into its part of
// p0[g][chunk][9*cin][o]
template <bool X2H>
__global__ void __launch_bounds__(DW_THREADS, 2) conv_dw_tc(TcConv p) {
  extern __shared__ __align__(16) uint8_t sm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int chunk = blockIdx.x, g = blockIdx.z;
  const int cs = blockIdx.y / p.nos, os = blockIdx.y - cs * p.nos;
  const int cin = p.c1 + p.c2;
  const int cs0 = cs * p.cb, cs_n = min(p.cb, cin - cs0);
  const int os0 = os * p.nb, os_n = min(p.nb, p.o - os0), ntn = (os_n + 7) / 8;
  int mt_lo = 0, mt_hi = (cs_n + 15) / 16;
  if (p.im2col) {  // warp w owns M tile w
    mt_lo = warp;
    mt_hi = warp < p.mp / 16 ? warp + 1 : warp;
  }
  const int t0 = chunk * p.span, t1 = min(t0 + p.span, p.per * p.tpi);
  float acc[MT_DW][NT_DW][4] = {};
  if (p.prologue) stage_affine(p, sm, g, tid, DW_THREADS);
  z_pad(p, sm, tid, DW_THREADS);
  if (t0 < t1) {
    const int img0 = g * p.per;
    dw_fetch<X2H>(p, sm, tile_at(p, img0 + t0 / p.tpi, t0 % p.tpi), warp, lane);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    dw_repack<X2H>(p, sm, tile_at(p, img0 + t0 / p.tpi, t0 % p.tpi), cs0, cs_n,
                   os0, os_n, tid);
    __syncthreads();
    for (int t = t0; t < t1; ++t) {
      const bool more = t + 1 < t1;
      const TileAt next = tile_at(p, img0 + (t + 1) / p.tpi, (t + 1) % p.tpi);
      if (more) {  // the next tile's runs load while this one multiplies
        dw_fetch<X2H>(p, sm, next, warp, lane);
        cp_async_commit();
      }
      dw_compute(p, smem_addr(sm), warp, lane, mt_lo, mt_hi, ntn, acc);
      cp_async_wait_all();
      __syncthreads();
      if (more) {
        dw_repack<X2H>(p, sm, next, cs0, cs_n, os0, os_n, tid);
        __syncthreads();
      }
    }
  }
  float* out = p.p0 + ((int64_t)g * p.chunks + chunk) * 9 * cin * p.o;
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT_DW; ++mt) {
    if (mt < mt_lo || mt >= mt_hi) continue;
#pragma unroll
    for (int nt = 0; nt < NT_DW; ++nt) {
      if (nt >= ntn) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = mt * 16 + gq + (i >> 1) * 8, n = nt * 8 + 2 * tq + (i & 1);
        if (n >= os_n) continue;
        int row;  // (tap, channel) row of dw
        if (p.im2col) {
          if (m >= 9 * cin) continue;
          row = m;
        } else {
          if (m >= cs_n) continue;
          row = warp * cin + cs0 + m;
        }
        out[(int64_t)row * p.o + os0 + n] = acc[mt][nt][i];
      }
    }
  }
}

// ---- K6 staging: the raw runs of the halo rows of g (zero outside the
// image), one a warp at a time, and the group's packed weights.  info:
// [th + 2] run offsets.
__device__ void dx_fetch_g(const TcConv& p, uint8_t* sm, TileAt tl, int warp, int lane) {
  const int H = p.h, W = p.w;
  const int lo = max(tl.c0 - 1, 0), hi = min(tl.c0 + TW + 1, W);
  int* info = (int*)(sm + p.o_info);
  for (int hr = warp; hr < p.th + 2; hr += DX_THREADS / 32) {
    const int sr = tl.r0 - 1 + hr;
    if (sr < 0 || sr >= H) continue;
    const int64_t st = ((int64_t)tl.img * H + sr) * W;
    copy_run(sm + p.o_rg + hr * p.rg, p.g, (st + lo) * p.o, (st + hi) * p.o, info + hr,
             lane);
  }
}

__device__ void dx_fetch_w(const TcConv& p, uint8_t* sm, int grp, int cs, int tid) {
  const int units = 9 * p.cb * p.ws / 8;  // 16-byte units
  const bf16* src = p.wpk + ((int64_t)grp * p.ncs + cs) * 9 * p.cb * p.ws;
  for (int e = tid; e < units; e += DX_THREADS)
    cp_async16(sm + p.o_w + e * 16, src + e * 8);
}

// g [(th+2) x 18 halo positions][opad], zero outside the image and past
// o; a thread keeps its 8-channel group q of a position
__device__ void dx_repack(const TcConv& p, uint8_t* sm, TileAt tl, int tid) {
  const int* info = (const int*)(sm + p.o_info);
  bf16* Gt = (bf16*)(sm + p.o_g);
  const int q8 = p.opad / 8, per = DX_THREADS / q8, q = tid % q8;
  const int n = min(8, p.o - 8 * q), lo = max(tl.c0 - 1, 0);
  for (int pos = tid < per * q8 ? tid / q8 : (p.th + 2) * HWD; pos < (p.th + 2) * HWD;
       pos += per) {
    const int hr = pos / HWD, hc = pos - hr * HWD;
    const int sr = tl.r0 - 1 + hr, scol = tl.c0 - 1 + hc;
    uint4 v = {0u, 0u, 0u, 0u};
    if (n > 0 && sr >= 0 && sr < p.h && scol >= 0 && scol < p.w)
      v = ld8((const bf16*)(sm + p.o_rg + hr * p.rg) + info[hr] + (scol - lo) * p.o +
                  8 * q, n);
    *reinterpret_cast<uint4*>(Gt + pos * p.ws + 8 * q) = v;
  }
}

// acc[nt] += G_t . W_t for the 16 pixels of tile row ``warp`` over the
// nine taps and o, the reflect folds as extra steps.  sbase: the
// shared-space address of the block's dynamic shared memory; frow, fcol:
// the fold bits of the warp's image row and of this lane's A-row column.
__device__ __forceinline__ void dx_compute(const TcConv& p, uint32_t sbase, int warp,
                                           int lane, int ntn, int frow, int fcol,
                                           float acc[NT_DX][4]) {
  const int mi = lane >> 3, r = lane & 7;
  const int ws2 = 2 * p.ws;  // bytes per staged row
  // this lane's A row: pixel (mi & 1) * 8 + r, channels (mi >> 1) * 8 on
  const uint32_t gt = sbase + p.o_g + ((mi & 1) * 8 + r) * ws2 + (mi >> 1) * 16;
  // its B rows: channel (mi >> 1) * 8 + r of an n-tile pair, o (mi & 1) * 8 on
  const uint32_t wb = sbase + p.o_w + ((mi >> 1) * 8 + r) * ws2 + (mi & 1) * 16;
  const uint32_t wb2 = sbase + p.o_w + r * ws2 + (mi & 1) * 16;
  const uint32_t zero = sbase + p.o_zero;
  const int tapw = p.cb * ws2, ntw = 8 * ws2;
  for (int t = 0; t < 9; ++t) {
    const int dy = t / 3, dx = t - 3 * dy;
    // the row fold: g row a - 1 + dy (0 or h-1) through this tap
    const bool rf = (dy == 0 && (frow & 1)) || (dy == 2 && (frow & 2));
    // the column fold of this lane's pixel
    const bool cf = (dx == 0 && (fcol & 1)) || (dx == 2 && (fcol & 2));
    const bool cany = __any_sync(0xffffffffu, cf);
    const uint32_t pd = gt + ((warp + 2 - dy) * HWD + 2 - dx) * ws2;
    const uint32_t pr = gt + ((warp + dy) * HWD + 2 - dx) * ws2;
    const uint32_t pc = gt + ((warp + 2 - dy) * HWD + dx) * ws2;
    const uint32_t pb = gt + ((warp + dy) * HWD + dx) * ws2;
    const uint32_t wt = wb + t * tapw, wt2 = wb2 + t * tapw;
    for (int k = 0; k < 2 * p.opad; k += 32) {  // bytes of 16 o
      uint32_t bw[NT_DX][2];
#pragma unroll
      for (int nt = 0; nt < NT_DX; nt += 2) {
        if (nt >= ntn) continue;
        if (nt + 1 < ntn) {
          uint32_t q[4];
          ldsm_x4(q, wt + nt * ntw + k);
          bw[nt][0] = q[0];
          bw[nt][1] = q[1];
          bw[nt + 1][0] = q[2];
          bw[nt + 1][1] = q[3];
        } else {
          ldsm_x2(bw[nt], wt2 + nt * ntw + k);
        }
      }
      uint32_t af[4];
      ldsm_x4(af, pd + k);
#pragma unroll
      for (int nt = 0; nt < NT_DX; ++nt)
        if (nt < ntn) mma16816(acc[nt], af, bw[nt]);
      if (rf) {
        ldsm_x4(af, pr + k);
#pragma unroll
        for (int nt = 0; nt < NT_DX; ++nt)
          if (nt < ntn) mma16816(acc[nt], af, bw[nt]);
      }
      if (cany) {  // rows of pixels the fold does not reach read zeros
        ldsm_x4(af, cf ? pc + k : zero);
#pragma unroll
        for (int nt = 0; nt < NT_DX; ++nt)
          if (nt < ntn) mma16816(acc[nt], af, bw[nt]);
        if (rf) {  // the corner: g[row fold][column fold]
          ldsm_x4(af, cf ? pb + k : zero);
#pragma unroll
          for (int nt = 0; nt < NT_DX; ++nt)
            if (nt < ntn) mma16816(acc[nt], af, bw[nt]);
        }
      }
    }
  }
}

// MODE 0: plain dx; 1: plain with the prologue backward; 2: the fold form.
// grid (images * chunks, ncs): block (image, tiles [bt * span, +span),
// channel slice); images = n (plain) or n2 (fold: the block loops over
// the S images r * per + image that share x2 image ``image``)
template <int MODE>
__global__ void __launch_bounds__(DX_THREADS, 2) conv_dx_tc(TcConv p) {
  extern __shared__ __align__(16) uint8_t sm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bimg = blockIdx.x / p.chunks, bt = blockIdx.x - bimg * p.chunks;
  const int cs = blockIdx.y, cin = p.c1 + p.c2;
  const int cs0 = cs * p.cb, cs_n = min(p.cb, cin - cs0), ntn = (cs_n + 7) / 8;
  const int t0 = bt * p.span, t1 = min(t0 + p.span, p.tpi);
  const int reps = MODE == 2 ? p.groups : 1;
  const int nsteps = (t1 - t0) * reps;
  const int gq = lane >> 2, tq = lane & 3;
  if (tid < 4) reinterpret_cast<uint32_t*>(sm + p.o_zero)[tid] = 0u;
  // step s: tile t0 + s / reps of image img_of(s)
  auto img_of = [&](int s) { return MODE == 2 ? (s % reps) * p.per + bimg : bimg; };
  auto tile_of = [&](int s) { return tile_at(p, img_of(s), t0 + s / reps); };
  float acc2[NT_DX][4] = {};                // fold: the x2 cotangent over the S images
  float ps[NT_DX][2] = {}, pq[NT_DX][2] = {};  // prologue: dscale, dshift
  int wgrp = img_of(0) / p.per;
  if (MODE == 1) {  // the group's prologue scale and shift of the slice
    float* aff = (float*)(sm + p.o_aff);
    for (int c = tid; c < cs_n; c += DX_THREADS) {
      aff[c] = p.sc[wgrp * p.c1 + cs0 + c];
      aff[p.cb + c] = p.sh[wgrp * p.c1 + cs0 + c];
    }
  }
  if (nsteps > 0) {
    dx_fetch_w(p, sm, wgrp, cs, tid);
    dx_fetch_g(p, sm, tile_of(0), warp, lane);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    dx_repack(p, sm, tile_of(0), tid);
    __syncthreads();
  }
  for (int s = 0; s < nsteps; ++s) {
    const TileAt tl = tile_of(s);
    const bool more = s + 1 < nsteps;
    if (more) {  // the next step's g runs load while this one multiplies
      dx_fetch_g(p, sm, tile_of(s + 1), warp, lane);
      cp_async_commit();
    }
    const int a = tl.r0 + warp;
    float acc[NT_DX][4] = {};
    if (warp < p.th && a < p.h) {
      const int bl = tl.c0 + (lane >> 3 & 1) * 8 + (lane & 7);  // the lane's A-row column
      dx_compute(p, smem_addr(sm), warp, lane, ntn, p.frow[a], bl < p.w ? p.fcol[bl] : 0,
                 acc);
      const float* aff = (const float*)(sm + p.o_aff);
#pragma unroll
      for (int n2 = 0; n2 < NT_DX; n2 += 2) {  // n-tile pairs
        if (n2 >= ntn) continue;
        float xv[2][4] = {};
        if (MODE == 1) {  // the pair's x1 values first: their loads overlap
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int bb = tl.c0 + gq + (i >> 1) * 8, n = (n2 + u) * 8 + 2 * tq + (i & 1);
              if (bb < p.w && n < cs_n)
                xv[u][i] = bf2f(p.x1[(((int64_t)tl.img * p.h + a) * p.w + bb) * p.c1 + cs0 + n]);
            }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int nt = n2 + u;
          if (nt >= ntn) continue;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int xx = gq + (i >> 1) * 8, bb = tl.c0 + xx;
            const int n = nt * 8 + 2 * tq + (i & 1), c = cs0 + n;
            if (bb >= p.w || n >= cs_n) continue;
            const int64_t pix = ((int64_t)tl.img * p.h + a) * p.w + bb;
            const float d = acc[nt][i];
            if (MODE == 0) {
              p.y[pix * p.c1 + c] = f2bf(d);
            } else if (MODE == 1) {
              const float sc = aff[n], sh = aff[p.cb + n], x = xv[u][i];
              const float da = __fadd_rn(__fmul_rn(x, sc), sh) > 0.f ? d : 0.f;
              p.y[pix * p.c1 + c] = f2bf(__fmul_rn(da, sc));
              ps[nt][i & 1] = fmaf(da, x, ps[nt][i & 1]);
              pq[nt][i & 1] += da;
            } else if (c < p.c1) {
              p.y[pix * p.c1 + c] = f2bf(d);
            } else {
              acc2[nt][i] += bf2f(f2bf(d));
            }
          }
        }
      }
      if (MODE == 2 && s % reps == reps - 1) {  // the tile's last image
#pragma unroll
        for (int nt = 0; nt < NT_DX; ++nt) {
          if (nt >= ntn) continue;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int bb = tl.c0 + gq + (i >> 1) * 8;
            const int c = cs0 + nt * 8 + 2 * tq + (i & 1);
            if (bb < p.w && c - cs0 < cs_n && c >= p.c1) {
              const int64_t pix2 = ((int64_t)bimg * p.h + a) * p.w + bb;
              p.y2[pix2 * p.c2 + c - p.c1] = f2bf(acc2[nt][i]);
            }
            acc2[nt][i] = 0.f;
          }
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
    if (more) {
      const int g1 = img_of(s + 1) / p.per;
      if (g1 != wgrp) {  // the fold form's next image is another group's
        dx_fetch_w(p, sm, g1, cs, tid);
        cp_async_commit();
        wgrp = g1;
      }
      dx_repack(p, sm, tile_of(s + 1), tid);
      cp_async_wait_all();
      __syncthreads();
    }
  }
  if (MODE == 1) {  // the block's dscale, dshift: lanes, then warps, in order
    float* red = (float*)(sm + p.o_red);
#pragma unroll
    for (int nt = 0; nt < NT_DX; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float vs = ps[nt][j], vq = pq[nt][j];
#pragma unroll
        for (int m = 4; m < 32; m <<= 1) {
          vs += __shfl_xor_sync(0xffffffffu, vs, m);
          vq += __shfl_xor_sync(0xffffffffu, vq, m);
        }
        if (gq == 0 && nt < ntn) {
          red[warp * p.cb + nt * 8 + 2 * tq + j] = vs;
          red[(8 + warp) * p.cb + nt * 8 + 2 * tq + j] = vq;
        }
      }
    __syncthreads();
    for (int c = tid; c < cs_n; c += DX_THREADS) {
      float vs = 0.f, vq = 0.f;
      for (int w = 0; w < 8; ++w) {
        vs += red[w * p.cb + c];
        vq += red[(8 + w) * p.cb + c];
      }
      p.p0[(int64_t)blockIdx.x * cin + cs0 + c] = vs;
      p.p1[(int64_t)blockIdx.x * cin + cs0 + c] = vq;
    }
  }
}

inline bool small(int64_t v) { return v >= 0 && v <= 0x3fffffff; }

// shape rules shared by the three entries
int check(int64_t n, int64_t h, int64_t w, int64_t c1, int64_t c2, int64_t n2,
          int64_t o, int64_t groups) {
  if (n <= 0 || h < 3 || w < 3 || c1 <= 0 || c2 < 0 || o <= 0 || groups <= 0 ||
      n % groups || !small(h * w) || c1 + c2 > 0xffff)
    return (int)cudaErrorInvalidValue;
  if (c2 > 0 && (n2 <= 0 || n % n2)) return (int)cudaErrorInvalidValue;
  return 0;
}

// x2_half_h needs x2, no prologue, an even h >= 4 and the lerp tables
bool bad_half(int64_t x2h, int64_t c2, int64_t h, int64_t prologue,
              const void* lo_h, const void* fa, const void* fb) {
  return x2h && (c2 <= 0 || prologue || h % 2 || h < 4 || !lo_h || !fa || !fb);
}

// the tile grid of the launch's plan (th tile rows, 16 columns)
bool tile_plan(TcConv& p, int64_t th, int64_t span) {
  if (th != 1 && th != 2 && th != 4 && th != 8) return false;
  if (span <= 0 || !small(span)) return false;
  p.th = (int)th;
  p.span = (int)span;
  p.tiles_w = (p.w + TW - 1) / TW;
  p.tpi = (p.h + p.th - 1) / p.th * p.tiles_w;
  p.per = p.n / p.groups;
  return small((int64_t)p.tpi * p.per);
}

// dynamic shared memory layout of K5; the wrapper's plan mirrors it
// (kernels/conv3x3_train.py fwd_plan).  x2's half-row pair is reserved
// with or without x2_half_h, so both forms take the same plan.
void fwd_layout(TcConv& p) {
  const int rows = p.th + 2;
  p.zs = stride8(p.im2col ? p.mp : p.cb);
  p.ws = stride8(p.nb);
  p.r1 = run_bytes(HWD, p.c1);
  p.r2 = p.c2 > 0 ? run_bytes(HWD, p.c2) : 0;
  int at = 0;
  p.o_w = at;
  at += (p.im2col ? p.mp : 9 * p.ncs * p.cb) * p.ws * 2;
  p.o_z = at;
  at += align16((p.im2col ? p.th * TW : rows * HWD) * p.zs * 2);
  p.o_r1 = at;
  at += rows * p.r1;
  p.o_r2 = at;
  at += rows * 2 * p.r2;
  p.o_info = at;
  at += align16(4 * rows * 4);
  p.o_aff = at;
  at += 2 * shift_at(p.c1) * 4;
  p.o_red = at;
  at += 2 * 8 * p.nb * 4;
  p.smem = at;
}

// dynamic shared memory layout of K7 (dw_plan in the wrapper)
void dw_layout(TcConv& p) {
  const int rows = p.th + 2;
  p.zs = stride8(p.im2col ? p.mp : p.cb);
  p.gs = stride8(p.nb);
  p.r1 = run_bytes(HWD, p.c1);
  p.r2 = p.c2 > 0 ? run_bytes(HWD, p.c2) : 0;
  p.rg = run_bytes(TW, p.o);
  int at = 0;
  p.o_z = at;
  at += align16((p.im2col ? p.th * TW : rows * HWD) * p.zs * 2);
  p.o_g = at;
  at += align16(p.th * TW * p.gs * 2);
  p.o_r1 = at;
  at += rows * p.r1;
  p.o_r2 = at;
  at += rows * 2 * p.r2;
  p.o_rg = at;
  at += p.th * p.rg;
  p.o_info = at;
  at += align16((4 * rows + p.th) * 4);
  p.o_aff = at;
  at += 2 * shift_at(p.c1) * 4;
  p.smem = at;
}

// dynamic shared memory layout of K6 (dx_plan in the wrapper)
void dx_layout(TcConv& p) {
  const int rows = p.th + 2;
  p.opad = (p.o + 15) / 16 * 16;
  p.ws = stride8(p.opad);
  p.rg = run_bytes(HWD, p.o);
  int at = 0;
  p.o_w = at;
  at += 9 * p.cb * p.ws * 2;
  p.o_g = at;
  at += rows * HWD * p.ws * 2;
  p.o_rg = at;
  at += rows * p.rg;
  p.o_info = at;
  at += align16(rows * 4);
  p.o_red = at;
  at += 2 * 8 * p.cb * 4;
  p.o_aff = at;
  at += 2 * p.cb * 4;
  p.o_zero = at;
  at += 16;
  p.smem = at;
}

bool aligned16(const void* q) { return ((uintptr_t)q & 15) == 0; }

template <typename K>
int launch_tc(K kernel, dim3 grid, int threads, const TcConv& p, void* stream) {
  if (p.smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, threads, p.smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// K5.  wpk: the weights packed for the wrapper's plan (pack_fwd_weights);
// th, cb, nb, span, im2col: that plan (fwd_plan: tile rows, channel and
// output slice widths, tiles per block, (tap, channel) folded into K);
// psum/psq: the per-block statistics [n * ceil(tiles / span), o].
extern "C" int mimo_conv3x3_fwd(const void* x1, const void* x2, const void* wpk,
                                const void* sc, const void* sh, const void* lo_h,
                                const void* fa, const void* fb, void* y,
                                void* psum, void* psq, int64_t n, int64_t h,
                                int64_t wd, int64_t c1, int64_t c2, int64_t n2,
                                int64_t o, int64_t groups, int64_t prologue,
                                int64_t x2_half_h, int64_t th, int64_t cb,
                                int64_t nb, int64_t span, int64_t im2col,
                                void* stream) {
  if (int e = check(n, h, wd, c1, c2, n2, o, groups)) return e;
  const int64_t cin = c1 + c2;
  if (cin > 256 || o > 256 || (prologue && c2 > 0) ||
      bad_half(x2_half_h, c2, h, prologue, lo_h, fa, fb) || nb <= 0 ||
      nb > 8 * NT_FWD || nb % 8 || !aligned16(x1) || !aligned16(wpk) ||
      (c2 > 0 && !aligned16(x2)) || (prologue && (!sc || !sh)) || !y || !psum || !psq)
    return (int)cudaErrorInvalidValue;
  if (im2col ? (9 * cin > CS_MAX || cb != 16) : (cb <= 0 || cb > CS_MAX || cb % 16))
    return (int)cudaErrorInvalidValue;
  TcConv p = {};
  p.x1 = (const bf16*)x1;
  p.x2 = (const bf16*)x2;
  p.wpk = (const bf16*)wpk;
  p.sc = (const float*)sc;
  p.sh = (const float*)sh;
  p.lo = (const int*)lo_h;
  p.fa = (const float*)fa;
  p.fb = (const float*)fb;
  p.y = (bf16*)y;
  p.p0 = (float*)psum;
  p.p1 = (float*)psq;
  p.n = (int)n; p.h = (int)h; p.w = (int)wd; p.c1 = (int)c1; p.c2 = (int)c2;
  p.n2 = c2 > 0 ? (int)n2 : 1; p.o = (int)o; p.groups = (int)groups;
  p.prologue = prologue != 0;
  if (!tile_plan(p, th, span)) return (int)cudaErrorInvalidValue;
  p.im2col = im2col != 0;
  p.mp = p.im2col ? (int)((9 * cin + 15) / 16 * 16) : 0;
  p.cb = (int)cb;
  p.ncs = p.im2col ? 1 : (int)((cin + cb - 1) / cb);
  p.nb = (int)nb;
  p.nos = (int)((o + nb - 1) / nb);
  p.chunks = (p.tpi + p.span - 1) / p.span;
  fwd_layout(p);
  if (n * p.chunks > 0x7fffffff || p.nos > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(n * p.chunks), (unsigned)p.nos);
  if (x2_half_h) return launch_tc(conv_fwd_tc<true>, grid, FWD_THREADS, p, stream);
  return launch_tc(conv_fwd_tc<false>, grid, FWD_THREADS, p, stream);
}

// K6.  th, cb, span: the wrapper's plan (tile rows, channel slice width,
// tiles per block); wpk the weights packed for it, frow/fcol the fold
// tables.  Plain form: c2 == 0, dx1 [n, h, w, c1], with the prologue the
// per-block dscale/dshift [n * ceil(tiles / span), c1].  Fold form: c2 >
// 0, n == groups * n2, dx2 [n2, h, w, c2].
extern "C" int mimo_conv3x3_dx(const void* g, const void* wpk, const void* frow,
                               const void* fcol, const void* x1, const void* sc,
                               const void* sh, void* dx1, void* dx2, void* pdsc,
                               void* pdsh, int64_t n, int64_t h, int64_t wd,
                               int64_t o, int64_t c1, int64_t c2, int64_t n2,
                               int64_t groups, int64_t prologue, int64_t th,
                               int64_t cb, int64_t span, void* stream) {
  if (int e = check(n, h, wd, c1, c2, n2, o, groups)) return e;
  if (o > 256 || (prologue && c2 > 0) || (c2 > 0 && n != groups * n2) ||
      cb <= 0 || cb > 8 * NT_DX || cb % 8 || !aligned16(g) || !aligned16(wpk) ||
      !frow || !fcol || (prologue && (!x1 || !sc || !sh || !pdsc || !pdsh)))
    return (int)cudaErrorInvalidValue;
  TcConv p = {};
  p.g = (const bf16*)g;
  p.wpk = (const bf16*)wpk;
  p.frow = (const int*)frow;
  p.fcol = (const int*)fcol;
  p.x1 = (const bf16*)x1;
  p.sc = (const float*)sc;
  p.sh = (const float*)sh;
  p.y = (bf16*)dx1;
  p.y2 = (bf16*)dx2;
  p.p0 = (float*)pdsc;
  p.p1 = (float*)pdsh;
  p.n = (int)n; p.h = (int)h; p.w = (int)wd; p.c1 = (int)c1; p.c2 = (int)c2;
  p.n2 = c2 > 0 ? (int)n2 : 1; p.o = (int)o; p.groups = (int)groups;
  p.prologue = prologue != 0;
  if (!tile_plan(p, th, span)) return (int)cudaErrorInvalidValue;
  p.cb = (int)cb;
  p.ncs = (int)((c1 + c2 + cb - 1) / cb);
  p.chunks = (p.tpi + p.span - 1) / p.span;
  dx_layout(p);
  const int64_t images = c2 > 0 ? n2 : n;
  if (images * p.chunks > 0x7fffffff || p.ncs > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(images * p.chunks), (unsigned)p.ncs);
  if (c2 > 0) return launch_tc(conv_dx_tc<2>, grid, DX_THREADS, p, stream);
  if (prologue) return launch_tc(conv_dx_tc<1>, grid, DX_THREADS, p, stream);
  return launch_tc(conv_dx_tc<0>, grid, DX_THREADS, p, stream);
}

// K7.  th, cb, nb, span, im2col: the wrapper's plan (tile rows, channel
// and output slice widths, tiles per chunk, (tap, channel) folded into M);
// partial [groups * ceil(per * tiles / span), 9 * (c1 + c2) * o].
extern "C" int mimo_conv3x3_dw(const void* x1, const void* x2, const void* g,
                               const void* sc, const void* sh, const void* lo_h,
                               const void* fa, const void* fb, void* partial,
                               int64_t n, int64_t h, int64_t wd, int64_t c1,
                               int64_t c2, int64_t n2, int64_t o,
                               int64_t groups, int64_t prologue,
                               int64_t x2_half_h, int64_t th, int64_t cb,
                               int64_t nb, int64_t span, int64_t im2col,
                               void* stream) {
  if (int e = check(n, h, wd, c1, c2, n2, o, groups)) return e;
  const int64_t cin = c1 + c2;
  if (cin > 256 || o > 256 || (prologue && c2 > 0) ||
      bad_half(x2_half_h, c2, h, prologue, lo_h, fa, fb) || nb <= 0 ||
      nb > 8 * NT_DW || nb % 8 || !aligned16(x1) || !aligned16(g) ||
      (c2 > 0 && !aligned16(x2)) || (prologue && (!sc || !sh)))
    return (int)cudaErrorInvalidValue;
  if (im2col ? (9 * cin > 16 * MT_DW || cb != 16) : (cb <= 0 || cb > 16 * MT_DW || cb % 16))
    return (int)cudaErrorInvalidValue;
  TcConv p = {};
  p.x1 = (const bf16*)x1;
  p.x2 = (const bf16*)x2;
  p.g = (const bf16*)g;
  p.sc = (const float*)sc;
  p.sh = (const float*)sh;
  p.lo = (const int*)lo_h;
  p.fa = (const float*)fa;
  p.fb = (const float*)fb;
  p.p0 = (float*)partial;
  p.n = (int)n; p.h = (int)h; p.w = (int)wd; p.c1 = (int)c1; p.c2 = (int)c2;
  p.n2 = c2 > 0 ? (int)n2 : 1; p.o = (int)o; p.groups = (int)groups;
  p.prologue = prologue != 0;
  if (!tile_plan(p, th, span)) return (int)cudaErrorInvalidValue;
  p.im2col = im2col != 0;
  p.mp = p.im2col ? (int)((9 * cin + 15) / 16 * 16) : 0;
  p.cb = (int)cb;
  p.ncs = p.im2col ? 1 : (int)((cin + cb - 1) / cb);
  p.nb = (int)nb;
  p.nos = (int)((o + nb - 1) / nb);
  p.chunks = (p.per * p.tpi + p.span - 1) / p.span;
  dw_layout(p);
  if ((int64_t)p.ncs * p.nos > 65535 || groups > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)p.chunks, (unsigned)(p.ncs * p.nos), (unsigned)groups);
  if (x2_half_h) return launch_tc(conv_dw_tc<true>, grid, DW_THREADS, p, stream);
  return launch_tc(conv_dw_tc<false>, grid, DW_THREADS, p, stream);
}

