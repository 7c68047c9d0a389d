// Fused eval DoubleConv, channels-last bf16:
//   relu(bn2(conv2(relu(bn1(conv1(cat(x1, x2)))))))  [-> 1x1 out-conv]
// with 3x3 reflect-padded convs and BatchNorm + bias folded into per-channel
// f32 (scale, shift).
//
// Replaces two TPU kernels of mimo_unet_tpu/ops/pallas/ct_conv.py:
//   * fused_double_conv_ct (:756, body _make_kernel :177): entry point
//     mimo_fused_double_conv with fixed_cin = 0 (channel count at run time);
//   * fused_double_conv9_ct (:496, body _make_kernel9 :327), the c_in <= 8
//     in_conv variant: the same entry with fixed_cin = c_in, which selects
//     an instantiation whose conv1 channel loop is unrolled at compile time.
// Options used by the flagship eval path:
//   * x2: a second concat input whose image period is n2 (image n reads x2
//     image n % n2: the S-major fold n = s*B + b shares the decoder's
//     upsampled core output across subnetworks);
//   * x2_half_h: x2 arrives at half height after the W half of the bilinear
//     x2 upsample; the align-corners H lerp runs here in f32, rounded to
//     bf16 (ct_conv.py:215-231), with the row tables of the x2 upsample
//     (kernels/upsample2x.py _h_tables: lo and f, the reference's
//     division by H-1 as the multiply by its f32 reciprocal that XLA
//     compiles it to);
//   * wo/bo: the fused 1x1 out-conv, logits rounded to bf16
//     (ct_conv.py:294-299);
//   * hpool: the row-pair max of the output (emit_hpool), the H half of the
//     2x2 pool that follows;
//   * group_rows_out: group g writes channel block g of [N/G, H, W, G*O],
//     the subnetwork channel concat the shared core reads.
// Rounding points are the TPU kernel's: bf16 operands, f32 accumulation,
// affine + relu on the f32 accumulator, the mid activation rounded to bf16
// before conv2.
//
// What bounds it on the H100: arithmetic.  At the flagship shapes the
// channel counts are small (3..168), so each output pixel is a long chain
// of multiply-adds over 9 taps x C_in, while its input and output are a
// few hundred bytes.  This first version runs the products on the f32
// CUDA cores, not the tensor cores (wgmma/TMA come later).  Design:
//   * one block per (image, 8-row x 16-column output tile), 256 threads;
//   * the input tile plus a 2-pixel halo is staged once in shared memory,
//     channel-major, so a warp's reads of one channel are contiguous;
//   * conv1 is recomputed on the 1-pixel halo of the mid tile, and the
//     mid tile stays in shared memory (never in device memory);
//   * reflect padding is an index map: the block computes mid only at real
//     image positions and reads mid row -1 as row 1 (and column -1 as
//     column 1), so conv2 sees the reflected *mid* values, as the TPU
//     kernel's mid-row overwrite does (ct_conv.py:269-277) -- never conv1
//     recomputed on a reflected input;
//   * weights are read from global memory (L1/L2-resident), eight output
//     channels per 16-byte load, shared by the whole warp: up3's conv1
//     weights alone are 254 KB, more than a block's shared memory;
//   * each thread accumulates two pixels x eight channels in registers;
//   * the output tile is staged in shared memory, so stores, the row-pair
//     max and the 1x1 out-conv read it and write coalesced rows.
#include "common.cuh"

namespace {

constexpr int TH = 8;    // output rows per block (even: row pairs for hpool)
constexpr int TW = 16;   // output columns per block
constexpr int NT = 256;  // threads per block
constexpr int CB = 8;    // output channels per thread: one 16-byte weight load
constexpr int SMEM_MAX = 232448;  // a block's dynamic shared memory on sm_90

struct Params {
  const bf16* x1;
  const bf16* x2;
  const bf16* w1;   // [G, 9, c1 + c2, mp]
  const float* s1;  // [G, mp]
  const float* sh1;
  const bf16* w2;   // [G, 9, m, op]
  const float* s2;  // [G, op]
  const float* sh2;
  const bf16* wo;   // [G, o, oc] or null
  const float* bo;  // [G, oc]
  bf16* out;
  bf16* hpool;      // null unless emitted
  const int* lo_h;  // x2_half_h: [h] first half row of full row r
  const float* fb;  // x2_half_h: [h] its lerp weight f
  int n, h, w, c1, c2, n2, x2_half_h, m, o, oc, groups, group_rows_out;
  int mp, op;       // m, o rounded up to CB
  int region_a;     // bytes of the slab / output-tile region
};

__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

// (scale, shift) affine on the f32 accumulator with explicit rounding, as
// the plain version's separate multiply and add
__device__ __forceinline__ float affine_relu(float acc, float s, float b) {
  return relu(__fadd_rn(__fmul_rn(acc, s), b));
}

// acc[p][k] += sum over 9 taps and cin channels of src[c][off_p[t]] * w[t][c][k]
// for two pixels p (offsets into a channel-major smem tile of plane
// ``plane``) and the CB output channels of ``wg`` (row stride ``ld``).
template <int FIXED_CIN>
__device__ __forceinline__ void conv_taps(const bf16* __restrict__ src,
                                          int plane, int cin,
                                          const int* off_a, const int* off_b,
                                          const bf16* __restrict__ wg, int ld,
                                          float* acc_a, float* acc_b) {
  const int nc = FIXED_CIN ? FIXED_CIN : cin;
#pragma unroll
  for (int t = 0; t < 9; ++t) {  // unrolled: off_a/off_b stay in registers
    const bf16* sa = src + off_a[t];
    const bf16* sb = src + off_b[t];
    const bf16* wt = wg + (int64_t)t * nc * ld;
#pragma unroll(FIXED_CIN ? FIXED_CIN : 4)
    for (int c = 0; c < nc; ++c) {
      float wf[CB];
      unpack8(__ldg(reinterpret_cast<const uint4*>(wt + (int64_t)c * ld)), wf);
      const float xa = bf2f(sa[c * plane]);
      const float xb = bf2f(sb[c * plane]);
#pragma unroll
      for (int k = 0; k < CB; ++k) {
        acc_a[k] = fmaf(xa, wf[k], acc_a[k]);
        acc_b[k] = fmaf(xb, wf[k], acc_b[k]);
      }
    }
  }
}

template <int FIXED_CIN>
__global__ void __launch_bounds__(NT) fused_double_conv_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int lerp_lo[TH + 4];
  __shared__ float lerp_f[TH + 4];

  const int tid = threadIdx.x;
  const int H = p.h, W = p.w;
  const int cin = FIXED_CIN ? FIXED_CIN : p.c1 + p.c2;
  const int img = blockIdx.z;
  const int per = p.n / p.groups;
  const int g = img / per;
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;

  // real-image ranges of the three tiles (halos clipped at the borders;
  // every reflected index lands inside them)
  const int sr0 = max(r0 - 2, 0), sr1 = min(r0 + TH + 2, H);
  const int sc0 = max(c0 - 2, 0), sc1 = min(c0 + TW + 2, W);
  const int mr0 = max(r0 - 1, 0), mr1 = min(r0 + TH + 1, H);
  const int mc0 = max(c0 - 1, 0), mc1 = min(c0 + TW + 1, W);
  const int sh = sr1 - sr0, sw = sc1 - sc0, splane = sh * sw;
  const int mh = mr1 - mr0, mw = mc1 - mc0, mplane = mh * mw;
  const int oh = min(TH, H - r0), ow = min(TW, W - c0), nout = oh * ow;

  bf16* slab = reinterpret_cast<bf16*>(smem);               // [cin][sh][sw]
  bf16* ytile = reinterpret_cast<bf16*>(smem);              // [nout][o], after conv1
  bf16* mid = reinterpret_cast<bf16*>(smem + p.region_a);   // [m][mh][mw]

  // ---- stage the input slab ------------------------------------------------
  {
    const int c1 = FIXED_CIN ? FIXED_CIN : p.c1;
    const bf16* x1i = p.x1 + (int64_t)img * H * W * c1;
    const int cnt = splane * c1;
    for (int idx = tid; idx < cnt; idx += NT) {
      const int c = idx % c1, pix = idx / c1;
      const int rr = pix / sw, cc = pix - rr * sw;
      slab[c * splane + pix] = x1i[((int64_t)(sr0 + rr) * W + sc0 + cc) * c1 + c];
    }
  }
  if (!FIXED_CIN && p.c2 > 0) {
    const int c1 = p.c1, c2 = p.c2;
    const int img2 = img % p.n2;
    bf16* slab2 = slab + c1 * splane;
    const int cnt = splane * c2;
    if (p.x2_half_h) {
      // align-corners H lerp from the half-height rows (ct_conv.py:215-231)
      const int H2 = H / 2;
      if (tid < sh) {
        lerp_lo[tid] = p.lo_h[sr0 + tid];
        lerp_f[tid] = p.fb[sr0 + tid];
      }
      __syncthreads();
      const bf16* x2i = p.x2 + (int64_t)img2 * H2 * W * c2;
      for (int idx = tid; idx < cnt; idx += NT) {
        const int c = idx % c2, pix = idx / c2;
        const int rr = pix / sw, cc = pix - rr * sw;
        const int64_t a = ((int64_t)lerp_lo[rr] * W + sc0 + cc) * c2 + c;
        const float f = lerp_f[rr];
        const float va = bf2f(x2i[a]), vb = bf2f(x2i[a + (int64_t)W * c2]);
        slab2[c * splane + pix] =
            f2bf(__fadd_rn(__fmul_rn(va, 1.0f - f), __fmul_rn(vb, f)));
      }
    } else {
      const bf16* x2i = p.x2 + (int64_t)img2 * H * W * c2;
      for (int idx = tid; idx < cnt; idx += NT) {
        const int c = idx % c2, pix = idx / c2;
        const int rr = pix / sw, cc = pix - rr * sw;
        slab2[c * splane + pix] = x2i[((int64_t)(sr0 + rr) * W + sc0 + cc) * c2 + c];
      }
    }
  }
  __syncthreads();

  // ---- conv1 + affine + relu -> mid (bf16, shared memory) -----------------
  {
    const int half = (mplane + 1) / 2;
    const int items = half * (p.mp / CB);
    const bf16* w1g = p.w1 + (int64_t)g * 9 * cin * p.mp;
    for (int item = tid; item < items; item += NT) {
      const int chunk = item / half, pa = item - chunk * half, pb = pa + half;
      const bool has_b = pb < mplane;
      const int qb = has_b ? pb : pa;
      const int ra = mr0 + pa / mw, ca = mc0 + pa % mw;
      const int rb = mr0 + qb / mw, cb = mc0 + qb % mw;
      int off_a[9], off_b[9];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          off_a[dy * 3 + dx] = (reflect(ra + dy - 1, H) - sr0) * sw
                               + reflect(ca + dx - 1, W) - sc0;
          off_b[dy * 3 + dx] = (reflect(rb + dy - 1, H) - sr0) * sw
                               + reflect(cb + dx - 1, W) - sc0;
        }
      }
      float acc_a[CB], acc_b[CB];
#pragma unroll
      for (int k = 0; k < CB; ++k) acc_a[k] = acc_b[k] = 0.f;
      conv_taps<FIXED_CIN>(slab, splane, cin, off_a, off_b,
                           w1g + chunk * CB, p.mp, acc_a, acc_b);
#pragma unroll
      for (int k = 0; k < CB; ++k) {
        const int mch = chunk * CB + k;
        if (mch < p.m) {
          const float s = p.s1[g * p.mp + mch], b = p.sh1[g * p.mp + mch];
          mid[mch * mplane + pa] = f2bf(affine_relu(acc_a[k], s, b));
          if (has_b) mid[mch * mplane + pb] = f2bf(affine_relu(acc_b[k], s, b));
        }
      }
    }
  }
  __syncthreads();  // the slab is dead from here: ytile reuses its space

  // ---- conv2 + affine + relu -> output tile (bf16, shared memory) ---------
  {
    const int half = (nout + 1) / 2;
    const int items = half * (p.op / CB);
    const bf16* w2g = p.w2 + (int64_t)g * 9 * p.m * p.op;
    for (int item = tid; item < items; item += NT) {
      const int chunk = item / half, pa = item - chunk * half, pb = pa + half;
      const bool has_b = pb < nout;
      const int qb = has_b ? pb : pa;
      const int ra = r0 + pa / ow, ca = c0 + pa % ow;
      const int rb = r0 + qb / ow, cb = c0 + qb % ow;
      int off_a[9], off_b[9];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          off_a[dy * 3 + dx] = (reflect(ra + dy - 1, H) - mr0) * mw
                               + reflect(ca + dx - 1, W) - mc0;
          off_b[dy * 3 + dx] = (reflect(rb + dy - 1, H) - mr0) * mw
                               + reflect(cb + dx - 1, W) - mc0;
        }
      }
      float acc_a[CB], acc_b[CB];
#pragma unroll
      for (int k = 0; k < CB; ++k) acc_a[k] = acc_b[k] = 0.f;
      conv_taps<0>(mid, mplane, p.m, off_a, off_b, w2g + chunk * CB, p.op,
                   acc_a, acc_b);
#pragma unroll
      for (int k = 0; k < CB; ++k) {
        const int och = chunk * CB + k;
        if (och < p.o) {
          const float s = p.s2[g * p.op + och], b = p.sh2[g * p.op + och];
          ytile[pa * p.o + och] = f2bf(affine_relu(acc_a[k], s, b));
          if (has_b) ytile[pb * p.o + och] = f2bf(affine_relu(acc_b[k], s, b));
        }
      }
    }
  }
  __syncthreads();

  // ---- epilogue: stores, row-pair max, or the fused 1x1 out-conv ----------
  const int O = p.o;
  if (p.wo != nullptr) {
    const int OC = p.oc;
    const bf16* wog = p.wo + (int64_t)g * O * OC;
    for (int idx = tid; idx < nout * OC; idx += NT) {
      const int pix = idx / OC, k = idx - pix * OC;
      const int i = pix / ow, j = pix - i * ow;
      float acc = 0.f;
      for (int och = 0; och < O; ++och)
        acc = fmaf(bf2f(ytile[pix * O + och]), bf2f(wog[och * OC + k]), acc);
      p.out[(((int64_t)img * H + r0 + i) * W + c0 + j) * OC + k] =
          f2bf(__fadd_rn(acc, p.bo[g * OC + k]));
    }
    return;
  }
  // group_rows_out: image img = g*per + b writes channel block g of
  // [per, H, W, G*O]; otherwise [N, H, W, O]
  const int64_t row_img = p.group_rows_out ? img - (int64_t)g * per : img;
  const int ldc = p.group_rows_out ? p.groups * O : O;
  const int cbase = p.group_rows_out ? g * O : 0;
  for (int idx = tid; idx < nout * O; idx += NT) {
    const int pix = idx / O, och = idx - pix * O;
    const int i = pix / ow, j = pix - i * ow;
    p.out[((row_img * H + r0 + i) * W + c0 + j) * ldc + cbase + och] = ytile[idx];
  }
  if (p.hpool != nullptr) {
    const int H2 = H / 2;
    for (int idx = tid; idx < (oh / 2) * ow * O; idx += NT) {
      const int pix = idx / O, och = idx - pix * O;
      const int i = pix / ow, j = pix - i * ow;
      const bf16 v = __hmax_nan(ytile[((2 * i) * ow + j) * O + och],
                                ytile[((2 * i + 1) * ow + j) * O + och]);
      p.hpool[((row_img * H2 + r0 / 2 + i) * W + c0 + j) * ldc + cbase + och] = v;
    }
  }
}

template <int FIXED_CIN>
int launch(const Params& p, int smem, cudaStream_t stream) {
  auto kernel = fused_double_conv_kernel<FIXED_CIN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.w + TW - 1) / TW, (p.h + TH - 1) / TH, p.n);
  kernel<<<grid, NT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

inline bool fits_int(int64_t v) { return v >= 0 && v <= 0x3fffffff; }

}  // namespace

extern "C" int mimo_fused_double_conv(
    const void* x1, const void* x2, const void* w1, const void* s1,
    const void* sh1, const void* w2, const void* s2, const void* sh2,
    const void* wo, const void* bo, void* out, void* hpool, const void* lo_h,
    const void* fb, int64_t n,
    int64_t h, int64_t w, int64_t c1, int64_t c2, int64_t n2,
    int64_t x2_half_h, int64_t m, int64_t o, int64_t oc, int64_t groups,
    int64_t group_rows_out, int64_t fixed_cin, void* stream) {
  const cudaError_t bad = cudaErrorInvalidValue;
  if (n <= 0 || n > 65535 || h < 2 || w < 2 || c1 <= 0 || c2 < 0 || m <= 0 ||
      o <= 0 || groups <= 0 || n % groups)
    return (int)bad;
  if (!fits_int(h) || !fits_int(w) || !fits_int(c1 + c2) || !fits_int(m) ||
      !fits_int(o) || !fits_int(oc))
    return (int)bad;
  if (c2 > 0 && (n2 <= 0 || n % n2 ||
                 (x2_half_h && (h % 2 || h < 4 || !lo_h || !fb))))
    return (int)bad;
  if (hpool != nullptr && (h % 2 || wo != nullptr)) return (int)bad;
  if (wo != nullptr && (oc <= 0 || group_rows_out)) return (int)bad;
  if (fixed_cin != 0 && (fixed_cin != c1 || c2 != 0 || fixed_cin > 8))
    return (int)bad;

  Params p;
  p.x1 = (const bf16*)x1;
  p.x2 = (const bf16*)x2;
  p.w1 = (const bf16*)w1;
  p.s1 = (const float*)s1;
  p.sh1 = (const float*)sh1;
  p.w2 = (const bf16*)w2;
  p.s2 = (const float*)s2;
  p.sh2 = (const float*)sh2;
  p.wo = (const bf16*)wo;
  p.bo = (const float*)bo;
  p.out = (bf16*)out;
  p.hpool = (bf16*)hpool;
  p.lo_h = (const int*)lo_h;
  p.fb = (const float*)fb;
  p.n = (int)n;
  p.h = (int)h;
  p.w = (int)w;
  p.c1 = (int)c1;
  p.c2 = (int)c2;
  p.n2 = c2 > 0 ? (int)n2 : 1;
  p.x2_half_h = c2 > 0 && x2_half_h;
  p.m = (int)m;
  p.o = (int)o;
  p.oc = (int)oc;
  p.groups = (int)groups;
  p.group_rows_out = (int)(group_rows_out != 0);
  p.mp = (int)((m + CB - 1) / CB * CB);
  p.op = (int)((o + CB - 1) / CB * CB);

  // region A holds the input slab, then the output tile; region B the mid
  const int64_t slab = (int64_t)(c1 + c2) * (TH + 4) * (TW + 4) * 2;
  const int64_t tile = (int64_t)TH * TW * o * 2;
  const int64_t region_a = ((slab > tile ? slab : tile) + 15) / 16 * 16;
  const int64_t smem = region_a + m * (TH + 2) * (TW + 2) * 2;
  if (smem + (int64_t)sizeof(int) * 2 * (TH + 4) > SMEM_MAX) return (int)bad;
  p.region_a = (int)region_a;

  cudaStream_t s = (cudaStream_t)stream;
  switch (fixed_cin) {
    case 0: return launch<0>(p, (int)smem, s);
    case 1: return launch<1>(p, (int)smem, s);
    case 2: return launch<2>(p, (int)smem, s);
    case 3: return launch<3>(p, (int)smem, s);
    case 4: return launch<4>(p, (int)smem, s);
    case 5: return launch<5>(p, (int)smem, s);
    case 6: return launch<6>(p, (int)smem, s);
    case 7: return launch<7>(p, (int)smem, s);
    case 8: return launch<8>(p, (int)smem, s);
    default: return (int)bad;
  }
}

extern "C" const char* mimo_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
