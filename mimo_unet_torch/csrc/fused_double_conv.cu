// Fused eval DoubleConv, channels-last bf16:
//   relu(bn2(conv2(relu(bn1(conv1(cat(x1, x2)))))))  [-> 1x1 out-conv]
// with 3x3 reflect-padded convs and BatchNorm + bias folded into per-channel
// f32 (scale, shift).
//
// Replaces two TPU kernels of mimo_unet_tpu/ops/pallas/ct_conv.py with one
// entry, mimo_fused_double_conv:
//   * fused_double_conv_ct (:756, body _make_kernel :177);
//   * fused_double_conv9_ct (:496, body _make_kernel9 :327), the c_in <= 8
//     in_conv variant: at c_in <= 7 with no x2 the block folds (tap,
//     channel) into conv1's K (im2col, below).
// Options used by the eval path:
//   * x2: a second concat input whose image period is n2 (image n reads x2
//     image n % n2: the S-major fold n = s*B + b shares the decoder's
//     upsampled core output across subnetworks);
//   * x2_half_h: x2 arrives at half height after the W half of the bilinear
//     x2 upsample; the align-corners H lerp runs as x2 is staged, once per
//     staged element, with the row tables of the x2 upsample
//     (kernels/upsample2x.py _h_tables: lo, fa = 1 - f, fb = f) and its
//     operation order, bf16(a*fa + b*fb) with no FMA (ct_conv.py:215-231):
//     the output is bit for bit that of the full-res x2 that upsample2x
//     would have written;
//   * wo/bo: the fused 1x1 out-conv, logits rounded to bf16
//     (ct_conv.py:294-299);
//   * hpool: the row-pair max of the output (emit_hpool), the H half of the
//     2x2 pool that follows;
//   * group_rows_out: group g writes channel block g of [N/G, H, W, G*O],
//     the subnetwork channel concat the shared core reads.
// Rounding points are the TPU kernel's: bf16 operands, f32 sums, the affine
// and relu on the f32 sum as a multiply then an add (no FMA), the mid
// activation rounded to bf16 before conv2, the output rounded to bf16; the
// out-conv multiplies the bf16 output by the bf16 wo, sums in f32 in channel
// order and adds the f32 bias before its rounding.
//
// What bounds it on the H100: arithmetic.  Per output pixel the two convs
// are 9*(C_in*M + M*O) multiply-adds (C_in, M, O = 3..480) against a few
// hundred bytes in and out, far above the memory roofline, so the products
// run on the tensor cores (mma.sync m16n8k16, bf16 operands, f32
// accumulators, fed by ldmatrix), as K5-K7 do (conv3x3_train.cu).  Design:
//   * a block walks output tiles of th x tw pixels (of one image each):
//     eight warps where the plan leaves room for two blocks a
//     multiprocessor, else sixteen (the same 128 registers a thread);
//   * the mid tile never leaves the chip: conv1 is recomputed on the mid
//     tile's one-pixel halo, and the mid stays in shared memory, bf16
//     [mid pixel][channel] with the channels padded to conv2's k-steps;
//   * conv1's input is staged a channel slice at a time: 16-byte cp.async
//     copies of the raw runs of the slab's rows (one run per row when one
//     slice holds every channel, else one per pixel of the slice's
//     channels), then a repack to bf16 [slab pixel][channel] with the
//     channels padded to 16 and a row stride of an odd number of 16-byte
//     units (stride8), the x2_half_h lerp applied there; at c_in <= 7 the
//     repack writes the im2col rows [mid pixel][tap * c_in + channel]
//     (27 -> 32) instead;
//   * the slab and the mid hold the image's real pixels only.  Padding is
//     an address map: a lane's ldmatrix row for pixel (r, c) and tap
//     (dy, dx) is the staged pixel (reflect(r + dy - 1), reflect(c + dx -
//     1)), so conv1 reads the reflected input and conv2 the reflected
//     *mid* (mid row -1 is mid row 1), as the TPU kernel's mid-row
//     overwrite does (ct_conv.py:269-277) -- never conv1 recomputed on a
//     reflected input.  The mid pixels are a flat list gathered by address
//     (im2col by address): a partial tile or an edge tile only has fewer
//     m-tiles;
//   * the weights are packed on the host (kernels/fused_double_conv.py
//     pack_weights) into chunks [9 taps][k-slice][n] per (pass, k-slice)
//     of conv1, then of conv2, each a flat copy into shared memory,
//     double-buffered: the next chunk's (and the next slice's raw runs')
//     copies run while the tensor cores work on this one.  A C_in wider
//     than one slice is restaged slice by slice and the accumulators kept
//     across slices, so the whole f32 sum exists before the one rounding;
//   * the warps split a conv's M (mid or output pixels, 16 a tile) and N
//     (channels, 8 a tile) in a grid wm x wn chosen on the host, each warp
//     holding at most MTW x NTW mma tiles in registers; channels beyond
//     what the grid holds take further passes over K;
//   * the output tile is staged in shared memory, so stores, the row-pair
//     max and the 1x1 out-conv read it and write coalesced rows.
// No atomics: every sum has a fixed order, so a launch gives the same bits
// as the last.
#include "common.cuh"
#include "ptx.cuh"

namespace {

constexpr int NTH_MAX = 512;  // threads a block: 256 (two blocks a multiprocessor) or 512
constexpr int MTW = 3;     // m-tiles (16 pixels) a warp holds at most
constexpr int NTW = 6;     // n-tiles (8 channels) a warp holds at most
constexpr int SMEM_MAX = 232448;  // dynamic shared memory of one block

struct Fdc {
  const bf16* x1;   // [n, h, w, c1]
  const bf16* x2;   // [n2, h, w, c2] ([n2, h/2, w, c2] with x2_half_h) or null
  const bf16* wpk;  // [G, wtot] packed weight chunks (pack_weights)
  const float* s1;  // [G, m] conv1 scale, shift
  const float* sh1;
  const float* s2;  // [G, o] conv2 scale, shift
  const float* sh2;
  const bf16* wo;   // [G, o, oc] or null
  const float* bo;  // [G, oc]
  const int* lo;    // x2_half_h: [h] first half row of full row r, its weights
  const float* fa;
  const float* fb;
  bf16* out;
  bf16* hpool;      // null unless emitted
  int n, h, w, c1, c2, n2, m, o, oc, groups, per, group_rows_out;
  int th, tw, tiles_h, tiles_w, tiles;  // output tile; tiles down, across, in all
  int im2col, cb, ncs;         // conv1 K: slice width (padded to 16), slices; im2col: cb = mp1
  int nb1, np1, wn1;           // conv1 N: pass width (padded to 8), passes, warps along N
  int cb2, ncs2, mp2;          // conv2 K: mid slice width, slices, mid width (ncs2 * cb2)
  int nb2, np2, wn2;           // conv2 N
  int ws1, ws2, zs, ms;        // row strides (elements): conv1 / conv2 chunks, slab, mid
  int chunk1, chunk2, wtot;    // elements of a conv1 / conv2 chunk, of a group's weights
  int rowrun;                  // raw runs: 1 a row (one k-slice), 0 a pixel
  int rx1, rx2;                // bytes of one raw run of x1, of x2
  int o_w, wbuf, o_mid, o_z, o_r1, o_r2, smem;  // byte offsets and sizes
};

// A tile: output rows [r0, r0 + oh) x columns [c0, c0 + ow); the
// mid tile one pixel around it and the input slab two pixels around it,
// both clipped to the image (reflected positions land inside them).
struct Blk {
  int img, g, r0, c0, oh, ow, nout;
  int sr0, sc0, sh, sw;        // slab: real rows and columns
  int mr0, mc0, mh, mw, mplane;
  int x2r0;                    // first staged x2 row (half row with x2_half_h)
};

// tile t of the launch: image t / (tiles_h * tiles_w), then tile rows
__device__ __forceinline__ Blk block_at(const Fdc& p, int t) {
  Blk b;
  const int tpi = p.tiles_h * p.tiles_w;
  b.img = t / tpi;
  b.g = b.img / p.per;
  const int tr = (t - b.img * tpi) / p.tiles_w;
  b.r0 = tr * p.th;
  b.c0 = (t - b.img * tpi - tr * p.tiles_w) * p.tw;
  b.oh = min(p.th, p.h - b.r0);
  b.ow = min(p.tw, p.w - b.c0);
  b.nout = b.oh * b.ow;
  b.sr0 = max(b.r0 - 2, 0);
  b.sc0 = max(b.c0 - 2, 0);
  b.sh = min(b.r0 + p.th + 2, p.h) - b.sr0;
  b.sw = min(b.c0 + p.tw + 2, p.w) - b.sc0;
  b.mr0 = max(b.r0 - 1, 0);
  b.mc0 = max(b.c0 - 1, 0);
  b.mh = min(b.r0 + p.th + 1, p.h) - b.mr0;
  b.mw = min(b.c0 + p.tw + 1, p.w) - b.mc0;
  b.mplane = b.mh * b.mw;
  b.x2r0 = b.sr0;
  if (p.lo != nullptr && p.c2 > 0) b.x2r0 = p.lo[b.sr0];
  return b;
}

// ---- conv1's input: raw runs, then the staged slab ------------------------

// cp.async the raw runs of one source into ``dst`` (slot run * rx), the
// slab's rows from row img_rows of the source on: with rowrun a run is a
// row's c channels over the slab's columns, a warp a run, its lanes over the
// run's 16-byte units; else a pixel's channels [a, a + k), a thread a run
__device__ __forceinline__ void fetch_source(const Fdc& p, const Blk& b, uint8_t* dst,
                                             int rx, const bf16* base, int64_t img_rows,
                                             int rows, int c, int a, int k) {
  if (p.rowrun) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int row = warp; row < rows; row += blockDim.x >> 5) {
      const int64_t s0 = ((img_rows + row) * p.w + b.sc0) * c, q0 = s0 >> 3;
      const int nq = (int)(((s0 + (int64_t)b.sw * c + 7) >> 3) - q0);
      for (int u = lane; u < nq; u += 32)
        cp_async16(dst + row * rx + u * 16, base + ((q0 + u) << 3));
    }
    return;
  }
  for (int run = threadIdx.x; run < rows * b.sw; run += blockDim.x) {
    const int row = run / b.sw;
    const int64_t s0 = ((img_rows + row) * p.w + b.sc0 + run - row * b.sw) * c + a;
    const int64_t q0 = s0 >> 3;
    const int nq = (int)(((s0 + k + 7) >> 3) - q0);
    for (int u = 0; u < nq; ++u) cp_async16(dst + run * rx + u * 16, base + ((q0 + u) << 3));
  }
}

// x1's and x2's channels of conv1's k-slice ks: [a1, a1 + k1) of x1 and
// [a2, a2 + k2) of x2 (k <= 0: none)
struct Sub {
  int a1, k1, a2, k2;
};

__device__ __forceinline__ Sub sub_of(const Fdc& p, int ks) {
  const int lo = ks * p.cb, hi = min(lo + p.cb, p.c1 + p.c2);
  Sub s;
  s.a1 = lo;
  s.k1 = min(hi, p.c1) - lo;
  s.a2 = max(lo, p.c1) - p.c1;
  s.k2 = hi - p.c1 - s.a2;
  return s;
}

// the raw runs of slice ks (x2's rows: the slab's, or with x2_half_h the
// half rows its lerp reads, lo[sr0] .. lo[last] + 1)
template <bool X2H>
__device__ void fetch_slice(const Fdc& p, const Blk& b, uint8_t* sm, int ks) {
  const Sub s = sub_of(p, ks);
  if (s.k1 > 0)
    fetch_source(p, b, sm + p.o_r1, p.rx1, p.x1, (int64_t)b.img * p.h + b.sr0, b.sh, p.c1,
                 s.a1, s.k1);
  if (s.k2 > 0) {
    const int i2 = b.img % p.n2;
    int rows = b.sh, hs = p.h;
    if constexpr (X2H) {
      hs = p.h / 2;
      rows = p.lo[b.sr0 + b.sh - 1] + 2 - b.x2r0;
    }
    fetch_source(p, b, sm + p.o_r2, p.rx2, p.x2, (int64_t)i2 * hs + b.x2r0, rows, p.c2,
                 s.a2, s.k2);
  }
}

// where channel ``a`` of the source's sub-slice [a, ..) of slab pixel
// (row, col) sits in its raw run (row: staged row index).  The run's
// element offset in its first 16-byte unit is the low 3 bits of its first
// element (fetch_source's s0), computed in 32 bits (the product wraps,
// those bits stay).
__device__ __forceinline__ const bf16* raw_at(const Fdc& p, const Blk& b, const uint8_t* raw,
                                              int rx, int64_t img_row, int row, int col,
                                              int c, int a) {
  const uint32_t px = (uint32_t)img_row * (uint32_t)p.w + (uint32_t)b.sc0;
  if (p.rowrun) return (const bf16*)(raw + row * rx) + ((px * c) & 7) + col * c + a;
  return (const bf16*)(raw + (row * b.sw + col) * rx) + (((px + col) * c + a) & 7);
}

// The staged slab of slice ks, [sh * sw pixels][zs]: eight channels a work
// item, x1's as bit copies, x2's as bit copies or lerped from its half
// rows (rounded once, as upsample2x rounds), zeros past the slice's
// channels.  An item that straddles the x1 | x2 boundary takes both.
template <bool X2H>
__device__ void repack_slice(const Fdc& p, const Blk& b, uint8_t* sm, int ks) {
  bf16* Z = (bf16*)(sm + p.o_z);
  const uint8_t* r1 = sm + p.o_r1;
  const uint8_t* r2 = sm + p.o_r2;
  const Sub s = sub_of(p, ks);
  const int q8 = p.cb / 8, items = b.sh * b.sw * q8;
  const int64_t row1 = (int64_t)b.img * p.h + b.sr0;
  const int64_t row2 = (int64_t)(b.img % p.n2) * (X2H ? p.h / 2 : p.h) + b.x2r0;
  for (int e = threadIdx.x; e < items; e += blockDim.x) {
    const int pos = e / q8, q = e - pos * q8;
    const int row = pos / b.sw, col = pos - row * b.sw;
    const int j0 = 8 * q;                              // slice channel of the item
    const int n1 = max(0, min(8, s.k1 - j0));          // x1 channels of the item
    const int j2 = max(0, j0 - max(s.k1, 0));          // its first x2 channel in the sub-slice
    const int n2 = max(0, min(8 - n1, s.k2 - j2));     // x2 channels
    bf16* dst = Z + pos * p.zs + j0;
    const bf16* v1 = nullptr;
    if (n1 > 0)
      v1 = raw_at(p, b, r1, p.rx1, row1 + row, row, col, p.c1, s.a1) + j0;
    if (n2 == 0) {  // x1 bits (or zeros past the slice)
      *reinterpret_cast<uint4*>(dst) = n1 > 0 ? ld8(v1, n1) : uint4{0u, 0u, 0u, 0u};
      continue;
    }
    const bf16* va;
    const bf16* vb = nullptr;
    float fa = 0.f, fb = 0.f;
    if constexpr (X2H) {
      const int r = b.sr0 + row, hr = p.lo[r] - b.x2r0;
      va = raw_at(p, b, r2, p.rx2, row2 + hr, hr, col, p.c2, s.a2) + j2;
      vb = raw_at(p, b, r2, p.rx2, row2 + hr + 1, hr + 1, col, p.c2, s.a2) + j2;
      fa = p.fa[r];
      fb = p.fb[r];
    } else {
      va = raw_at(p, b, r2, p.rx2, row2 + row, row, col, p.c2, s.a2) + j2;
    }
    if (n1 == 0) {
      if constexpr (X2H) {  // eight x2 channels lerped from the half rows
        float fva[8], fvb[8], v[8];
        unpack8(ld8(va, n2), fva);
        unpack8(ld8(vb, n2), fvb);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = __fadd_rn(__fmul_rn(fva[j], fa), __fmul_rn(fvb[j], fb));
        st8(dst, v);  // the lerp's one rounding
      } else {  // x2 bits
        *reinterpret_cast<uint4*>(dst) = ld8(va, n2);
      }
      continue;
    }
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float x = 0.f;
      if (j < n1) {
        x = bf2f(v1[j]);
      } else if (j < n1 + n2) {
        x = bf2f(va[j - n1]);
        if constexpr (X2H) x = __fadd_rn(__fmul_rn(x, fa), __fmul_rn(bf2f(vb[j - n1]), fb));
      }
      v[j] = x;
    }
    st8(dst, v);  // the lerp's one rounding
  }
}

// im2col: [mplane][zs], column t * C1 + c of mid pixel q is x1 channel c at
// its tap t's reflected pixel, zeros in columns [9 * C1, cb): a thread a
// pixel, its row built in registers and stored as 16-byte units
template <int C1>
__device__ void repack_im2col_c(const Fdc& p, const Blk& b, uint8_t* sm) {
  constexpr int K = (9 * C1 + 15) / 16 * 16;  // cb
  bf16* Z = (bf16*)(sm + p.o_z);
  const uint8_t* r1 = sm + p.o_r1;
  const int64_t row1 = (int64_t)b.img * p.h + b.sr0;
  for (int q = threadIdx.x; q < b.mplane; q += blockDim.x) {
    const int mr = b.mr0 + q / b.mw, mc = b.mc0 + q % b.mw;
    uint32_t v[K / 2];
#pragma unroll
    for (int i = 0; i < K / 2; ++i) v[i] = 0u;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int r = reflect(mr + dy - 1, p.h) - b.sr0;
      const bf16* row = raw_at(p, b, r1, p.rx1, row1 + r, r, 0, C1, 0);
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const uint16_t* src = reinterpret_cast<const uint16_t*>(
            row + (reflect(mc + dx - 1, p.w) - b.sc0) * C1);
#pragma unroll
        for (int c = 0; c < C1; ++c) {
          const int k = (dy * 3 + dx) * C1 + c;
          v[k / 2] |= (uint32_t)src[c] << (16 * (k & 1));
        }
      }
    }
    uint4* dst = reinterpret_cast<uint4*>(Z + q * p.zs);
#pragma unroll
    for (int i = 0; i < K / 8; ++i) dst[i] = uint4{v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]};
  }
}

__device__ void repack_im2col(const Fdc& p, const Blk& b, uint8_t* sm) {
  switch (p.c1) {
    case 1: repack_im2col_c<1>(p, b, sm); break;
    case 2: repack_im2col_c<2>(p, b, sm); break;
    case 3: repack_im2col_c<3>(p, b, sm); break;
    case 4: repack_im2col_c<4>(p, b, sm); break;
    case 5: repack_im2col_c<5>(p, b, sm); break;
    case 6: repack_im2col_c<6>(p, b, sm); break;
    default: repack_im2col_c<7>(p, b, sm); break;
  }
}

// zeros that no pass writes, once a block: the mid's channels [m, mp2)
// (conv2's K padding) of every mid pixel a tile can have
__device__ void zero_pads(const Fdc& p, uint8_t* sm) {
  bf16* mid = (bf16*)(sm + p.o_mid);
  const int padm = p.mp2 - p.m, px = (p.th + 2) * (p.tw + 2);
  for (int e = threadIdx.x; e < px * padm; e += blockDim.x)
    mid[(e / padm) * p.ms + p.m + e % padm] = f2bf(0.f);
}

// weight chunk s (conv1's pass-major (pass, slice) chunks, then conv2's)
// of group g into buffer buf
__device__ void fetch_chunk(const Fdc& p, uint8_t* sm, int g, int s, int buf) {
  const int s1 = p.np1 * p.ncs;
  const int64_t at = s < s1 ? (int64_t)s * p.chunk1
                            : (int64_t)s1 * p.chunk1 + (int64_t)(s - s1) * p.chunk2;
  const int units = (s < s1 ? p.chunk1 : p.chunk2) / 8;
  const bf16* src = p.wpk + (int64_t)g * p.wtot + at;
  uint8_t* dst = sm + p.o_w + buf * p.wbuf;
  for (int e = threadIdx.x; e < units; e += blockDim.x) cp_async16(dst + e * 16, src + e * 8);
}

// ---- the products -----------------------------------------------------------

// This lane's ldmatrix A rows in one conv: for each of its m-tiles j, the
// shared-space byte address of its pixel at tap (1, 1), and 4 bits that
// say which of its neighbours above, below, left and right the reflect
// turns around (a pixel on the image's edge reads the one inside); line
// and pix: the bytes between staged rows and between staged pixels.
struct ARows {
  uint32_t base[MTW];
  uint32_t edges;  // bits 4j..4j+3: m-tile j's top, bottom, left, right edge
  int line, pix;
};

// the A row of m-tile j for pixel (r, c) of the image, staged at row
// r - r0s, column c - c0s of a tile ``cols`` pixels wide
__device__ __forceinline__ void arow_at(ARows& a, int j, uint32_t base, int r, int c,
                                        int r0s, int c0s, int cols, const Fdc& p) {
  a.base[j] = base + ((r - r0s) * cols + c - c0s) * a.pix;
  a.edges |= (uint32_t)((r == 0) | (r == p.h - 1) << 1 | (c == 0) << 2 | (c == p.w - 1) << 3)
             << (4 * j);
}

// the byte address of tap (dy, dx)'s pixel in m-tile j's A row
__device__ __forceinline__ uint32_t arow_tap(const ARows& a, int j, int dy, int dx) {
  const uint32_t e = a.edges >> (4 * j);
  int off = 0;
  if (dy == 0) off -= (e & 1) ? -a.line : a.line;
  if (dy == 2) off += (e & 2) ? -a.line : a.line;
  if (dx == 0) off -= (e & 4) ? -a.pix : a.pix;
  if (dx == 2) off += (e & 8) ? -a.pix : a.pix;
  return a.base[j] + off;
}

// acc[j][nt] += A_j,t . B_t,nt over the taps t < NTAP (9: A_j,t is the
// tap's view of the staged pixels; 1: the im2col rows) and k-steps k < nk:
// A_j,t 16 pixels x 16 channels (+32 bytes a k-step), B_t the chunk's rows
// [t * kr + 16k, +16) at wb (this lane's row, the warp's first n-tile),
// ws2 bytes a row.  mlive m-tiles and ntn n-tiles (warp-uniform) are live.
template <int NTAP>
__device__ __forceinline__ void conv_mma(const ARows& a, int nk, int kr, uint32_t wb, int ws2,
                                         int mlive, int ntn, float acc[MTW][NTW][4]) {
#pragma unroll
  for (int t = 0; t < NTAP; ++t) {
    const int dy = t / 3, dx = t - 3 * (t / 3);
    uint32_t aa[MTW];
#pragma unroll
    for (int j = 0; j < MTW; ++j) aa[j] = NTAP == 1 ? a.base[j] : arow_tap(a, j, dy, dx);
    const uint32_t wt = wb + t * kr * ws2;
    for (int k = 0; k < nk; ++k) {
      uint32_t bw[NTW][2];
#pragma unroll
      for (int nt = 0; nt < NTW; nt += 2) {
        if (nt >= ntn) continue;
        if (nt + 1 < ntn) {
          uint32_t q[4];
          ldsm_x4_t(q, wt + 16 * k * ws2 + nt * 16);
          bw[nt][0] = q[0];
          bw[nt][1] = q[1];
          bw[nt + 1][0] = q[2];
          bw[nt + 1][1] = q[3];
        } else {
          ldsm_x2_t(bw[nt], wt + 16 * k * ws2 + nt * 16);  // lanes 0-15 give the rows
        }
      }
#pragma unroll
      for (int j = 0; j < MTW; ++j) {
        if (j >= mlive) continue;
        uint32_t af[4];
        ldsm_x4(af, aa[j] + 32 * k);
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt)
          if (nt < ntn) mma16816(acc[j][nt], af, bw[nt]);
      }
    }
  }
}

// A warp's share of one conv: m-tiles wm + j * wm_n (j < MTW) of mt_n,
// n-tiles [nt0, nt0 + ntn) of the pass
struct Share {
  int wm, wmn, mlive, nt0, ntn;
};

__device__ __forceinline__ Share share_of(int warp, int wn_n, int mt_n, int pass, int nb,
                                          int nch) {
  Share s;
  const int wn = warp % wn_n;
  s.wm = warp / wn_n;
  s.wmn = (blockDim.x >> 5) / wn_n;
  s.mlive = min(MTW, max(0, (mt_n - s.wm + s.wmn - 1) / s.wmn));
  s.nt0 = wn * NTW;
  const int width = min(nb, nch - pass * nb);  // the pass's real channels
  s.ntn = min(NTW, max(0, (width + 7) / 8 - s.nt0));
  return s;
}

// this lane's A row pixel of m-tile j (its row within the 16 of the tile:
// (lane >> 3 & 1) * 8 + (lane & 7)), pixel 0 past the tile's npx
__device__ __forceinline__ int lane_px(const Share& sh, int j, int lane, int npx) {
  const int q = (sh.wm + j * sh.wmn) * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
  return q < npx ? q : 0;
}

// one step of conv1: pass ``pass``, the staged k-slice, weight chunk at wb
__device__ __forceinline__ void conv1_step(const Fdc& p, const Blk& b, uint8_t* sm,
                                           uint32_t wb, int pass, int warp, int lane,
                                           float acc[MTW][NTW][4]) {
  const Share sh = share_of(warp, p.wn1, (b.mplane + 15) / 16, pass, p.nb1, p.m);
  if (sh.mlive == 0 || sh.ntn == 0) return;
  const int mi = lane >> 3, r = lane & 7;
  const int ws2 = 2 * p.ws1, zs2 = 2 * p.zs;
  const uint32_t zb = smem_addr(sm + p.o_z) + (mi >> 1) * 16;
  const uint32_t wl = wb + ((mi & 1) * 8 + r) * ws2 + (mi >> 1) * 16 + sh.nt0 * 16;
  ARows a;
  a.edges = 0;
  a.line = b.sw * zs2;
  a.pix = zs2;
#pragma unroll
  for (int j = 0; j < MTW; ++j) {
    const int q = lane_px(sh, j, lane, b.mplane);  // mid pixel
    if (p.im2col)
      a.base[j] = zb + q * zs2;
    else
      arow_at(a, j, zb, b.mr0 + q / b.mw, b.mc0 + q % b.mw, b.sr0, b.sc0, b.sw, p);
  }
  if (p.im2col)
    conv_mma<1>(a, p.cb / 16, 0, wl, ws2, sh.mlive, sh.ntn, acc);
  else
    conv_mma<9>(a, p.cb / 16, p.cb, wl, ws2, sh.mlive, sh.ntn, acc);
}

// one step of conv2: pass ``pass``, mid k-slice ks
__device__ __forceinline__ void conv2_step(const Fdc& p, const Blk& b, uint8_t* sm,
                                           uint32_t wb, int pass, int ks, int warp,
                                           int lane, float acc[MTW][NTW][4]) {
  const Share sh = share_of(warp, p.wn2, (b.nout + 15) / 16, pass, p.nb2, p.o);
  if (sh.mlive == 0 || sh.ntn == 0) return;
  const int mi = lane >> 3, r = lane & 7;
  const int ws2 = 2 * p.ws2, ms2 = 2 * p.ms;
  const uint32_t mb = smem_addr(sm + p.o_mid) + (mi >> 1) * 16 + ks * p.cb2 * 2;
  const uint32_t wl = wb + ((mi & 1) * 8 + r) * ws2 + (mi >> 1) * 16 + sh.nt0 * 16;
  ARows a;
  a.edges = 0;
  a.line = b.mw * ms2;
  a.pix = ms2;
#pragma unroll
  for (int j = 0; j < MTW; ++j) {
    const int q = lane_px(sh, j, lane, b.nout);  // output pixel
    arow_at(a, j, mb, b.r0 + q / b.ow, b.c0 + q % b.ow, b.mr0, b.mc0, b.mw, p);
  }
  conv_mma<9>(a, p.cb2 / 16, p.cb2, wl, ws2, sh.mlive, sh.ntn, acc);
}

// A pass epilogue: v = relu(acc * scale + shift) of the pass's channels
// (the affine of group g, nch channels) for the warp's live pixels (< npx),
// handed to put(pixel, channel, v0, v1, n): channels ch, ch + 1 (n of
// them real; ch even)
template <class Put>
__device__ __forceinline__ void pass_store(const Share& sh, int pass, int nb, int nch,
                                           const float* scale, const float* shift, int lane,
                                           int npx, float acc[MTW][NTW][4], Put put) {
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt) {
    if (nt >= sh.ntn) continue;
    const int ch0 = pass * nb + (sh.nt0 + nt) * 8 + 2 * tq;
    float sc[2], sf[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      sc[u] = ch0 + u < nch ? scale[ch0 + u] : 0.f;
      sf[u] = ch0 + u < nch ? shift[ch0 + u] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < MTW; ++j) {
      if (j >= sh.mlive) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows gq, gq + 8 of the m-tile
        const int q = (sh.wm + j * sh.wmn) * 16 + gq + h * 8;
        if (q < npx && ch0 < nch)
          put(q, ch0, relu(__fadd_rn(__fmul_rn(acc[j][nt][2 * h], sc[0]), sf[0])),
              relu(__fadd_rn(__fmul_rn(acc[j][nt][2 * h + 1], sc[1]), sf[1])),
              min(2, nch - ch0));
      }
    }
  }
}

// conv1's pass epilogue: the mid at the pass's channels of the real mid
// pixels, rounded to bf16
__device__ __forceinline__ void conv1_store(const Fdc& p, const Blk& b, uint8_t* sm, int pass,
                                            int warp, int lane, float acc[MTW][NTW][4]) {
  const Share sh = share_of(warp, p.wn1, (b.mplane + 15) / 16, pass, p.nb1, p.m);
  bf16* mid = (bf16*)(sm + p.o_mid);
  const int ms = p.ms;
  pass_store(sh, pass, p.nb1, p.m, p.s1 + b.g * p.m, p.sh1 + b.g * p.m, lane, b.mplane, acc,
             [&](int q, int ch, float v0, float v1, int n) {
               if (n == 2)  // q * ms + ch is even: a 4-byte store
                 *reinterpret_cast<__nv_bfloat162*>(mid + q * ms + ch) =
                     __floats2bfloat162_rn(v0, v1);
               else
                 mid[q * ms + ch] = f2bf(v0);
             });
}

// conv2's pass epilogue: the output tile [nout][o], rounded to bf16
__device__ __forceinline__ void conv2_store(const Fdc& p, const Blk& b, uint8_t* sm, int pass,
                                            int warp, int lane, float acc[MTW][NTW][4]) {
  const Share sh = share_of(warp, p.wn2, (b.nout + 15) / 16, pass, p.nb2, p.o);
  bf16* y = (bf16*)(sm + p.o_z);
  const int o = p.o;
  pass_store(sh, pass, p.nb2, p.o, p.s2 + b.g * p.o, p.sh2 + b.g * p.o, lane, b.nout, acc,
             [&](int q, int ch, float v0, float v1, int n) {
               y[q * o + ch] = f2bf(v0);
               if (n == 2) y[q * o + ch + 1] = f2bf(v1);
             });
}

// max of two bf16, NaN if either is (torch.maximum)
__device__ __forceinline__ bf16 max_nan(bf16 a, bf16 b) {
  const float x = bf2f(a), y = bf2f(b);
  return (x != x || x >= y) ? a : b;
}

// dst[e] = src[e] (with src2: the max of src[e] and src2[e]) for e < n, by
// threads t, t + nth, ...: 16-byte units where every run is 16-byte
// aligned and whole, bf16 pairs where dst and the sources share their
// 4-byte alignment, else single values
__device__ __forceinline__ void copy_seg(bf16* dst, const bf16* src, const bf16* src2, int n,
                                         int t, int nth) {
  auto val = [&](int e) { return src2 ? max_nan(src[e], src2[e]) : src[e]; };
  const uintptr_t d = (uintptr_t)dst;
  if (((d | (uintptr_t)src | (uintptr_t)src2) & 15) == 0 && n % 8 == 0) {  // 16-byte units
    for (int e = t; e < n / 8; e += nth) {
      uint4 v = reinterpret_cast<const uint4*>(src)[e];
      if (src2) {
        const uint4 w = reinterpret_cast<const uint4*>(src2)[e];
        bf16* a = reinterpret_cast<bf16*>(&v);
        const bf16* c = reinterpret_cast<const bf16*>(&w);
#pragma unroll
        for (int k = 0; k < 8; ++k) a[k] = max_nan(a[k], c[k]);
      }
      reinterpret_cast<uint4*>(dst)[e] = v;
    }
    return;
  }
  const bool pairs = ((d ^ (uintptr_t)src) & 2) == 0 &&
                     (src2 == nullptr || ((d ^ (uintptr_t)src2) & 2) == 0);
  if (!pairs) {
    for (int e = t; e < n; e += nth) dst[e] = val(e);
    return;
  }
  const int lead = (d & 2) ? 1 : 0, np = (n - lead) / 2;
  if (t == 0 && lead && n > 0) dst[0] = val(0);
  if (t == 0 && lead + 2 * np < n) dst[n - 1] = val(n - 1);
  for (int e = t; e < np; e += nth) {
    const int at = lead + 2 * e;
    __nv_bfloat162 v;
    v.x = val(at);
    v.y = val(at + 1);
    *reinterpret_cast<__nv_bfloat162*>(dst + at) = v;
  }
}

// stores of the output tile [nout][o] (y): rows, the row-pair max, or the
// fused 1x1 out-conv (a thread a pixel, its OC sums in channel order)
__device__ void epilogue(const Fdc& p, const Blk& b, const bf16* y) {
  const int O = p.o, tid = threadIdx.x;
  if (p.wo != nullptr) {
    const int OC = p.oc;
    const bf16* wog = p.wo + (int64_t)b.g * O * OC;
    for (int q = tid; q < b.nout; q += blockDim.x) {
      const int i = q / b.ow, j = q - i * b.ow;
      bf16* dst = p.out + (((int64_t)b.img * p.h + b.r0 + i) * p.w + b.c0 + j) * OC;
      for (int k = 0; k < OC; ++k) {
        float acc = 0.f;
        for (int ch = 0; ch < O; ++ch)
          acc = fmaf(bf2f(y[q * O + ch]), bf2f(wog[ch * OC + k]), acc);
        dst[k] = f2bf(__fadd_rn(acc, p.bo[b.g * OC + k]));
      }
    }
    return;
  }
  const int64_t H2 = p.h / 2;
  if (!p.group_rows_out) {  // [N, H, W, O]: a tile row is one run
    const int len = b.ow * O;
    for (int i = 0; i < b.oh; ++i)
      copy_seg(p.out + (((int64_t)b.img * p.h + b.r0 + i) * p.w + b.c0) * O,
               y + i * len, nullptr, len, tid, blockDim.x);
    if (p.hpool != nullptr)
      for (int i = 0; i < b.oh / 2; ++i)
        copy_seg(p.hpool + (((int64_t)b.img * H2 + b.r0 / 2 + i) * p.w + b.c0) * O,
                 y + 2 * i * len, y + (2 * i + 1) * len, len, tid, blockDim.x);
    return;
  }
  // group_rows_out: image img = g*per + i writes channel block g of
  // [per, H, W, G*O]: a pixel's O channels are one run; a thread a (pixel,
  // channel pair), single channels where O is odd
  const int64_t row_img = b.img - (int64_t)b.g * p.per;
  const int ldc = p.groups * O, cbase = b.g * O;
  const int v = O % 2 == 0 ? 2 : 1, nv = O / v;
  for (int e = tid; e < b.nout * nv; e += blockDim.x) {
    const int q = e / nv, k = (e - q * nv) * v;
    const int i = q / b.ow, j = q - i * b.ow;
    bf16* dst = p.out + ((row_img * p.h + b.r0 + i) * p.w + b.c0 + j) * ldc + cbase + k;
    if (v == 2)
      *reinterpret_cast<__nv_bfloat162*>(dst) =
          *reinterpret_cast<const __nv_bfloat162*>(y + q * O + k);
    else
      *dst = y[q * O + k];
  }
  if (p.hpool != nullptr)
    for (int e = tid; e < (b.oh / 2) * b.ow * nv; e += blockDim.x) {
      const int q = e / nv, k = (e - q * nv) * v;
      const int i = q / b.ow, j = q - i * b.ow;
      const bf16* top = y + ((2 * i) * b.ow + j) * O + k;
      const bf16* bot = top + b.ow * O;
      bf16* dst = p.hpool + ((row_img * H2 + b.r0 / 2 + i) * p.w + b.c0 + j) * ldc + cbase + k;
      dst[0] = max_nan(top[0], bot[0]);
      if (v == 2) dst[1] = max_nan(top[1], bot[1]);
    }
}

// The staged input of conv1's first slice of tile b, its raw runs landed
template <bool X2H>
__device__ __forceinline__ void repack_first(const Fdc& p, const Blk& b, uint8_t* sm) {
  if (p.im2col)
    repack_im2col(p, b, sm);
  else
    repack_slice<X2H>(p, b, sm, 0);
}

// grid (blocks): block i takes tiles i, i + blocks, ...  A tile's steps are
// conv1's (pass, k-slice) pairs, then conv2's; step s multiplies with
// weight chunk s while the next step's chunk (and, where conv1 restages,
// the next slice's raw runs) are copied; the last step copies the next
// tile's first chunk and raw runs, so a block's tiles follow each other
// with no copy waited for.
template <bool X2H>
__global__ void __launch_bounds__(NTH_MAX, 1) fused_double_conv_tc(Fdc p) {
  extern __shared__ __align__(16) uint8_t sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int t = blockIdx.x;
  if (t >= p.tiles) return;
  Blk b = block_at(p, t);
  const int s1 = p.np1 * p.ncs, steps = s1 + p.np2 * p.ncs2;
  // conv1 restages its slab at step s (0 < s < s1) when it holds a new slice
  auto restage = [&](int s) { return s < s1 && p.ncs > 1; };
  zero_pads(p, sm);
  fetch_chunk(p, sm, b.g, 0, 0);
  fetch_slice<X2H>(p, b, sm, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  repack_first<X2H>(p, b, sm);
  __syncthreads();
  float acc[MTW][NTW][4];
  int buf = 0;  // the weight buffer of the step
  for (;;) {
    const int tn = t + gridDim.x;
    const bool more = tn < p.tiles;
    for (int s = 0; s < steps; ++s, buf ^= 1) {
      const bool conv1 = s < s1;
      const int pass = conv1 ? s / p.ncs : (s - s1) / p.ncs2;
      const int ks = conv1 ? s - pass * p.ncs : s - s1 - pass * p.ncs2;
      if (s + 1 < steps) {
        fetch_chunk(p, sm, b.g, s + 1, buf ^ 1);
        if (restage(s + 1)) fetch_slice<X2H>(p, b, sm, (s + 1) % p.ncs);
      } else if (more) {  // the next tile's first chunk and slice
        const Blk bn = block_at(p, tn);
        fetch_chunk(p, sm, bn.g, 0, buf ^ 1);
        fetch_slice<X2H>(p, bn, sm, 0);
      }
      cp_async_commit();
      if (ks == 0) {
#pragma unroll
        for (int j = 0; j < MTW; ++j)
#pragma unroll
          for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[j][nt][i] = 0.f;
      }
      const uint32_t wb = smem_addr(sm + p.o_w + buf * p.wbuf);
      if (conv1) {
        conv1_step(p, b, sm, wb, pass, warp, lane, acc);
        if (ks == p.ncs - 1) conv1_store(p, b, sm, pass, warp, lane, acc);
      } else {
        conv2_step(p, b, sm, wb, pass, ks, warp, lane, acc);
        if (ks == p.ncs2 - 1) conv2_store(p, b, sm, pass, warp, lane, acc);
      }
      cp_async_wait_all();
      __syncthreads();
      if (restage(s + 1)) {
        repack_slice<X2H>(p, b, sm, (s + 1) % p.ncs);
        __syncthreads();
      }
    }
    epilogue(p, b, (const bf16*)(sm + p.o_z));
    if (!more) break;
    __syncthreads();  // the output tile is read: the slab's space is free
    t = tn;
    b = block_at(p, t);
    repack_first<X2H>(p, b, sm);
    __syncthreads();
  }
}

// Dynamic shared memory layout; the wrapper's plan mirrors it
// (kernels/fused_double_conv.py plan_of).  The output tile reuses the
// slab's space (dead once conv1 is done), not the raw runs' (the next
// tile's copies land there meanwhile).  x2's runs are reserved for th + 4
// rows with or without x2_half_h, so both forms take the same plan.
void layout(Fdc& p) {
  const int srows = p.th + 4, scols = p.tw + 4;
  const int mid_px = (p.th + 2) * (p.tw + 2);
  p.ws1 = stride8(p.nb1);
  p.ws2 = stride8(p.nb2);
  p.zs = stride8(p.cb);
  p.ms = stride8(p.mp2);
  p.chunk1 = (p.im2col ? p.cb : 9 * p.cb) * p.ws1;
  p.chunk2 = 9 * p.cb2 * p.ws2;
  p.wtot = p.np1 * p.ncs * p.chunk1 + p.np2 * p.ncs2 * p.chunk2;
  p.rowrun = p.ncs == 1;
  const int k1 = p.cb < p.c1 ? p.cb : p.c1, k2 = p.cb < p.c2 ? p.cb : p.c2;
  p.rx1 = p.rowrun ? run_bytes(scols, p.c1) : run_bytes(1, k1);
  p.rx2 = p.c2 == 0 ? 0 : p.rowrun ? run_bytes(scols, p.c2) : run_bytes(1, k2);
  const int rpr = p.rowrun ? 1 : scols;
  int at = 0;
  p.o_w = at;
  p.wbuf = 2 * (p.chunk1 > p.chunk2 ? p.chunk1 : p.chunk2);
  at += 2 * p.wbuf;
  p.o_mid = at;
  at += align16(mid_px * p.ms * 2);
  p.o_z = at;
  const int z = align16((p.im2col ? mid_px : srows * scols) * p.zs * 2);
  const int ytile = align16(p.th * p.tw * p.o * 2);
  at += z > ytile ? z : ytile;
  p.o_r1 = at;
  at += srows * rpr * p.rx1;
  p.o_r2 = at;
  at += srows * rpr * p.rx2;
  p.smem = at;
}

inline bool small(int64_t v) { return v >= 0 && v <= 0x3fffffff; }

bool aligned16(const void* q) { return ((uintptr_t)q & 15) == 0; }

bool pow2_16(int64_t v) { return v == 1 || v == 2 || v == 4 || v == 8 || v == 16; }

// whether a warp grid of ``warps`` warps, wn of them along N, spreads the
// m-tiles of a conv's M (px pixels) within MTW tiles a warp
bool grid_fits(int64_t px, int64_t wn, int64_t warps) {
  return pow2_16(wn) && wn <= warps && (px + 15) / 16 <= MTW * (warps / wn);
}

}  // namespace

// th, tw: the output tile; cb, ncs via cb: conv1's k-slice width (im2col:
// 9 * c1 padded to 16); wn1, np1 via nb1: conv1's warps along N and pass
// width; the same for conv2 (cb2 the mid slice width, nb2, wn2) -- the
// wrapper's plan (kernels/fused_double_conv.py plan_of); wpk the weights
// packed for it; threads: a block's (256: two blocks a multiprocessor, 512:
// one); blocks: the grid (each block takes every blocks-th tile).
extern "C" int mimo_fused_double_conv(
    const void* x1, const void* x2, const void* wpk, const void* s1, const void* sh1,
    const void* s2, const void* sh2, const void* wo, const void* bo, void* out,
    void* hpool, const void* lo_h, const void* fa, const void* fb, int64_t n, int64_t h,
    int64_t w, int64_t c1, int64_t c2, int64_t n2, int64_t x2_half_h, int64_t m, int64_t o,
    int64_t oc, int64_t groups, int64_t group_rows_out, int64_t th, int64_t tw,
    int64_t im2col, int64_t cb, int64_t nb1, int64_t wn1, int64_t cb2, int64_t nb2,
    int64_t wn2, int64_t threads, int64_t blocks, void* stream) {
  const int bad = (int)cudaErrorInvalidValue;
  if (n <= 0 || !small(n) || h < 2 || w < 2 || c1 <= 0 || c2 < 0 || m <= 0 || o <= 0 ||
      groups <= 0 || n % groups || !small(h * w) || !small(c1 + c2) || !small(m) ||
      !small(o) || !small(oc))
    return bad;
  if (c2 > 0 && (n2 <= 0 || n % n2 || !x2 || !aligned16(x2) ||
                 (x2_half_h && (h % 2 || h < 4 || !lo_h || !fa || !fb))))
    return bad;
  if (hpool != nullptr && (h % 2 || wo != nullptr)) return bad;
  if (wo != nullptr && (oc <= 0 || group_rows_out || !bo)) return bad;
  if (!aligned16(x1) || !aligned16(wpk) || !out || !s1 || !sh1 || !s2 || !sh2) return bad;
  // the plan: tile rows even (row pairs), k-slices of whole k-steps, pass
  // widths of whole n-tiles, warp grids that hold a whole tile's m-tiles
  if (th < 2 || th % 2 || th > 64 || tw < 1 || tw > 64 || cb <= 0 || cb % 16 ||
      cb2 <= 0 || cb2 % 16 || nb1 <= 0 || nb1 % 8 || nb2 <= 0 || nb2 % 8 ||
      (threads != 256 && threads != NTH_MAX) ||
      !grid_fits((th + 2) * (tw + 2), wn1, threads / 32) ||
      !grid_fits(th * tw, wn2, threads / 32) ||
      nb1 > wn1 * NTW * 8 || nb2 > wn2 * NTW * 8)
    return bad;
  if (im2col ? (c2 > 0 || cb < 9 * c1 || cb > 64) : cb > 256) return bad;
  Fdc p = {};
  p.x1 = (const bf16*)x1;
  p.x2 = (const bf16*)x2;
  p.wpk = (const bf16*)wpk;
  p.s1 = (const float*)s1;
  p.sh1 = (const float*)sh1;
  p.s2 = (const float*)s2;
  p.sh2 = (const float*)sh2;
  p.wo = (const bf16*)wo;
  p.bo = (const float*)bo;
  p.out = (bf16*)out;
  p.hpool = (bf16*)hpool;
  const bool half = c2 > 0 && x2_half_h;
  p.lo = half ? (const int*)lo_h : nullptr;
  p.fa = half ? (const float*)fa : nullptr;
  p.fb = half ? (const float*)fb : nullptr;
  p.n = (int)n; p.h = (int)h; p.w = (int)w; p.c1 = (int)c1; p.c2 = (int)c2;
  p.n2 = c2 > 0 ? (int)n2 : 1;
  p.m = (int)m; p.o = (int)o; p.oc = (int)oc; p.groups = (int)groups;
  p.per = (int)(n / groups);
  p.group_rows_out = group_rows_out != 0;
  p.th = (int)th; p.tw = (int)tw;
  p.tiles_h = (int)((h + th - 1) / th);
  p.tiles_w = (int)((w + tw - 1) / tw);
  if (!small((int64_t)p.tiles_h * p.tiles_w * n) || blocks <= 0 || !small(blocks)) return bad;
  p.tiles = p.tiles_h * p.tiles_w * (int)n;
  p.im2col = im2col != 0;
  p.cb = (int)cb;
  p.ncs = p.im2col ? 1 : (int)((c1 + c2 + cb - 1) / cb);
  p.nb1 = (int)nb1;
  p.np1 = (int)((m + nb1 - 1) / nb1);
  p.wn1 = (int)wn1;
  p.cb2 = (int)cb2;
  p.ncs2 = (int)((m + cb2 - 1) / cb2);
  p.mp2 = p.ncs2 * p.cb2;
  p.nb2 = (int)nb2;
  p.np2 = (int)((o + nb2 - 1) / nb2);
  p.wn2 = (int)wn2;
  layout(p);
  if (p.smem > SMEM_MAX) return bad;
  const dim3 grid((unsigned)(blocks < p.tiles ? blocks : p.tiles));
  auto kernel = half ? fused_double_conv_tc<true> : fused_double_conv_tc<false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       p.smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, (int)threads, p.smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* mimo_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
