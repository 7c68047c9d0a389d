// Train-mode 3x3 reflect conv per subnetwork group, channels-last bf16, and
// its two backward kernels:
//   * mimo_conv3x3_fwd: y = conv(z), z = x or relu(x*scale+shift) (the
//     previous BatchNorm's affine as a prologue); y rounded to bf16, no
//     bias; per-channel sum and sum of squares of the *rounded* y, per
//     block (the wrapper reduces them per group).  Optional second concat
//     input x2 whose image n is x2 image n % n2; with x2_half_h it arrives
//     at half height, W-upsampled (upsample_w2x.cu), and the gather lerps
//     its rows (below).
//     Replaces mimo_unet_tpu/ops/pallas/ct_train.py:283 _conv_fwd
//     (pallas_call :318), reached through conv3x3_ct_train :1099.
//   * mimo_conv3x3_dx: dz = transpose of (reflect pad + conv) applied to g;
//     without x2, optionally the prologue backward fused in
//     (da = dz*[a>0], dx = da*scale, per-block dscale += da*x, dshift +=
//     da); with x2 (the fold form) each block loops over the S images that
//     share one x2 image and sums their bf16-rounded x2 cotangents in f32.
//     Replaces ct_train.py:579 _conv_dx (pallas_call :648) and :677
//     _conv_dx_fold_call (:697).
//   * mimo_conv3x3_dw: per-block partial dw over a chunk of one group's
//     pixels, the recomputed z contracted with g (the wrapper reduces the
//     chunks), x2_half_h as in the forward.  Replaces ct_train.py:815
//     _conv_dw (pallas_call :853).
//
// All three are implicit GEMMs with a gathered operand: the fwd is
// [pixels x 9*Cin] . [9*Cin x O], the dx [pixels x 9*O] . [9*O x Cin] and
// the dw [9*Cin x pixels] . [pixels x O].  The gather does the padding:
//   * fwd and dw read x at reflect(i + dy - 1), reflect(j + dx - 1); with
//     x2_half_h (ct_train.py:238 _x2_half_spec, :255 _stage_x2_half) the
//     x2 value of full row r is bf16(a * fa[r] + b * fb[r]) from half rows
//     a = lo[r] and b = lo[r] + 1, no FMA: the tables and the operation
//     order of the x2 upsample's H lerp (upsample2x.cu), so y, its
//     statistics and dw are bit for bit those of the full-res x2 that the
//     upsample would have written;
//   * dx reads g zero-padded at (a + 1 - dy, b + 1 - dx) plus the additive
//     reflect folds (ct_train.py:26-31): pixel row 1 also takes g row 0
//     through tap dy = 0 and row H-2 takes g row H-1 through dy = 2 (the
//     same for columns), so one gathered element sums up to four g values.
// Rounding points are the TPU kernels': bf16 operands, f32 accumulation,
// the prologue z computed in f32 and rounded to bf16 before the product
// (ct_train.py:151-156), statistics of the bf16 y (:220-224), dx rounded
// once, the fold's per-image cotangents rounded before their f32 sum.
//
// What bounds it on the H100: arithmetic.  Per output pixel the products
// are 9*Cin*O multiply-adds (Cin, O = 3..63), against a few hundred bytes
// in and out, so at these channel counts the work sits above the memory
// roofline.  This first version runs the products on the f32 CUDA cores:
// a 128 x 32 output tile per block, within one image (an image's last
// tile is partial when 128 does not divide h*w: its missing rows repeat
// the last pixel), 256 threads, each holding a 4 x 4
// register tile fed by two 16-byte shared-memory loads per 16 FMAs; the
// A operand is gathered from device memory into shared memory in f32, 32
// columns at a time.  Reductions across blocks (statistics, dscale,
// dshift, dw) go to per-block partials that a second pass sums per group
// in a fixed order: results do not change from run to run.  Tensor cores
// (mma.sync/wgmma) and TMA staging are later work.
#include "common.cuh"

namespace {

constexpr int BM = 128;      // GEMM tile rows
constexpr int BN = 32;       // GEMM tile columns
constexpr int BK = 32;       // reduction depth per step
constexpr int NT = 256;      // threads per block: 32 row groups x 8 column groups
constexpr int AS = BM + 4;   // row stride of the A tile (16-byte aligned)
// the longest gathered dimension, 9 x 256 channels; the gather's (tap,
// channel) table ktab is dynamic shared memory of the launch's K ints
constexpr int KMAX = 2304;

__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

// relu(x*scale + shift) rounded to bf16, as the prologue z
__device__ __forceinline__ float prologue_z(float x, float s, float b) {
  return bf2f(f2bf(relu(__fadd_rn(__fmul_rn(x, s), b))));
}

// acc[i][j] += sum_k A[k][tm*4 + i] * B[k][tn*4 + j] over one BK step
__device__ __forceinline__ void tile_fma(const float* __restrict__ As,
                                         const float* __restrict__ Bs, int tm,
                                         int tn, float acc[4][4]) {
#pragma unroll 8
  for (int k = 0; k < BK; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(As + k * AS + tm * 4);
    const float4 b = *reinterpret_cast<const float4*>(Bs + k * BN + tn * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Sum v[j] (this thread's 4 columns) over the block's 32 row groups in a
// fixed order; threads 0..BN-1 receive the column sums (red: 32*BN floats).
__device__ __forceinline__ float column_sum(float* red, const float v[4],
                                            int tm, int tn, int tid) {
#pragma unroll
  for (int j = 0; j < 4; ++j) red[tm * BN + tn * 4 + j] = v[j];
  __syncthreads();
  float s = 0.f;
  if (tid < BN)
    for (int r = 0; r < NT / 8; ++r) s += red[r * BN + tid];
  __syncthreads();
  return s;
}

struct Conv {
  const bf16* x1;   // [n, h, w, c1]
  const bf16* x2;   // [n2, h, w, c2] ([n2, h/2, w, c2] with x2_half_h) or null
  const bf16* wgt;  // fwd: [G, 9*cin, np]; dx: [G, 9*o, np]
  const bf16* g;    // [n, h, w, o] (dx, dw)
  const float* sc;  // [G, c1] prologue scale, or null
  const float* sh;
  bf16* y;          // fwd: [n, h, w, o]; dx: dx1 [n, h, w, c1]
  bf16* y2;         // dx fold: dx2 [n2, h, w, c2]
  float* p0;        // per-block partials: sum / dscale / dw
  float* p1;        // sumsq / dshift
  int n, h, w, c1, c2, n2, o, groups, prologue, np, chunk, chunks;
};

// x2_half_h's row tables, a kernel argument of their own: Conv stays at 128
// bytes (at 160, with these in it, the fwd, dx and dw kernels all ran 4-10 %
// slower: NVIDIA H100 80GB HBM3, 700 W)
struct Lerp {
  const int* lo;    // [h] first half row of full row r
  const float* fa;  // [h] its weights 1 - f and f
  const float* fb;
};

// One element of the fwd/dw gather: z at reflect(i+dy-1), reflect(j+dx-1),
// channel c of the concat [x1, x2] of image img, group g.  X2H (a template
// flag, so that the full-res instantiation carries no lerp code): x2 at
// half height, its rows lerped.
template <bool X2H>
__device__ __forceinline__ float gather_z(const Conv& p, const Lerp& l, int img,
                                          int g, int i, int j, int t, int c) {
  const int dy = t / 3, dx = t - 3 * dy;
  const int r = reflect(i + dy - 1, p.h), s = reflect(j + dx - 1, p.w);
  const int64_t pix = ((int64_t)img * p.h + r) * p.w + s;
  if (c < p.c1) {
    const float v = bf2f(p.x1[pix * p.c1 + c]);
    return p.prologue ? prologue_z(v, p.sc[g * p.c1 + c], p.sh[g * p.c1 + c]) : v;
  }
  if constexpr (X2H) {  // the H lerp of full row r from half rows lo[r], lo[r] + 1
    const int64_t a =
        (((int64_t)(img % p.n2) * (p.h / 2) + l.lo[r]) * p.w + s) * p.c2 + c - p.c1;
    const float va = bf2f(p.x2[a]), vb = bf2f(p.x2[a + (int64_t)p.w * p.c2]);
    return bf2f(f2bf(__fadd_rn(__fmul_rn(va, l.fa[r]), __fmul_rn(vb, l.fb[r]))));
  }
  const int64_t pix2 = pix + (int64_t)(img % p.n2 - img) * p.h * p.w;
  return bf2f(p.x2[pix2 * p.c2 + c - p.c1]);
}

// One element of the dx gather: the sum of g[img, r, s, oc] over the rows r
// and columns s that tap (dy, dx) of pixel (a, b) reaches, reflect folds
// included.
__device__ __forceinline__ float gather_g(const Conv& p, int img, int a, int b,
                                          int t, int oc) {
  const int H = p.h, W = p.w;
  const int dy = t / 3, dx = t - 3 * dy;
  const int r = a + 1 - dy, s = b + 1 - dx;
  const bool rv = r >= 0 && r < H, sv = s >= 0 && s < W;
  const int rf = (dy == 0 && a == 1) ? 0 : ((dy == 2 && a == H - 2) ? H - 1 : -1);
  const int sf = (dx == 0 && b == 1) ? 0 : ((dx == 2 && b == W - 2) ? W - 1 : -1);
  const bf16* gi = p.g + (int64_t)img * H * W * p.o + oc;
  float v = 0.f;
  if (rv) {
    if (sv) v += bf2f(gi[((int64_t)r * W + s) * p.o]);
    if (sf >= 0) v += bf2f(gi[((int64_t)r * W + sf) * p.o]);
  }
  if (rf >= 0) {
    if (sv) v += bf2f(gi[((int64_t)rf * W + s) * p.o]);
    if (sf >= 0) v += bf2f(gi[((int64_t)rf * W + sf) * p.o]);
  }
  return v;
}

// A tile (BM output pixels x BK gathered columns) of the fwd or dx GEMM for
// the block's pixels (rows prow, columns pcol of image img); B tile from the
// packed weights [G, K, np].
template <bool DX, bool X2H = false>
__device__ __forceinline__ void load_tiles(const Conv& p, const Lerp& l, int img,
                                           int g, int k0,
                                           int K, int nb, const int* ktab,
                                           const int* prow, const int* pcol,
                                           float* As, float* Bs, int tid) {
#pragma unroll 4
  for (int r = 0; r < BM * BK / NT; ++r) {
    const int e = tid + r * NT, kk = e % BK, mm = e / BK, k = k0 + kk;
    float v = 0.f;
    if (k < K) {
      const int code = ktab[k], t = code >> 16, c = code & 0xffff;
      v = DX ? gather_g(p, img, prow[mm], pcol[mm], t, c)
             : gather_z<X2H>(p, l, img, g, prow[mm], pcol[mm], t, c);
    }
    As[kk * AS + mm] = v;
  }
  const bf16* wg = p.wgt + (int64_t)g * K * p.np;
#pragma unroll
  for (int r = 0; r < BK * BN / NT; ++r) {
    const int e = tid + r * NT, nn = e % BN, kk = e / BN, k = k0 + kk;
    Bs[kk * BN + nn] = k < K ? bf2f(wg[(int64_t)k * p.np + nb + nn]) : 0.f;
  }
}

// the block's BM pixels [rem, rem + BM) of one image as rows and columns;
// past the image's last pixel (the tail tile of an image whose pixel count
// BM does not divide) the rows repeat that pixel: they compute its values
// again, write the same values to it, and the statistics weigh them 0
__device__ __forceinline__ void fill_pixels(int* prow, int* pcol, int rem, int w,
                                            int hw, int tid) {
  for (int m = tid; m < BM; m += NT) {
    const int q = min(rem + m, hw - 1);
    prow[m] = q / w;
    pcol[m] = q % w;
  }
}

// tiles per image: ceil(h*w / BM); block b covers image b / tiles
__device__ __forceinline__ int tiles_per_image(int hw) { return (hw + BM - 1) / BM; }

__device__ __forceinline__ void fill_ktab(int* ktab, int K, int div, int tid) {
  for (int k = tid; k < K; k += NT) {
    const int t = k / div;
    ktab[k] = (t << 16) | (k - t * div);
  }
}

// grid (n * ceil(h*w / BM), ceil(o / BN))
template <bool X2H>
__global__ void __launch_bounds__(NT) conv_fwd_kernel(Conv p, Lerp l) {
  __shared__ __align__(16) float As[BK * AS];
  __shared__ __align__(16) float Bs[BK * BN];
  extern __shared__ int ktab[];  // [K]: dynamic, sized at launch
  __shared__ int prow[BM], pcol[BM];
  const int tid = threadIdx.x, tm = tid / 8, tn = tid % 8;
  const int HW = p.h * p.w, cin = p.c1 + p.c2, K = 9 * cin;
  const int tpi = tiles_per_image(HW);
  const int img = blockIdx.x / tpi, rem = (blockIdx.x % tpi) * BM;
  const int g = img / (p.n / p.groups), nb = blockIdx.y * BN;
  fill_ktab(ktab, K, cin, tid);
  fill_pixels(prow, pcol, rem, p.w, HW, tid);
  __syncthreads();

  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tiles<false, X2H>(p, l, img, g, k0, K, nb, ktab, prow, pcol, As, Bs, tid);
    __syncthreads();
    tile_fma(As, Bs, tm, tn, acc);
    __syncthreads();
  }

  float s[4] = {}, q[4] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = rem + tm * 4 + i;
    const int64_t pix = (int64_t)img * HW + min(m, HW - 1);
    const float live = m < HW ? 1.f : 0.f;  // a repeated pixel counts nothing
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = nb + tn * 4 + j;
      if (n < p.o) {
        const bf16 v = f2bf(acc[i][j]);
        p.y[pix * p.o + n] = v;
        const float f = bf2f(v) * live;
        s[j] += f;
        q[j] = fmaf(f, f, q[j]);
      }
    }
  }
  const float cs = column_sum(As, s, tm, tn, tid);
  const float cq = column_sum(As, q, tm, tn, tid);
  if (tid < BN && nb + tid < p.o) {
    p.p0[blockIdx.x * (int64_t)p.o + nb + tid] = cs;
    p.p1[blockIdx.x * (int64_t)p.o + nb + tid] = cq;
  }
}

// plain form (c2 == 0): grid (n * ceil(h*w / BM), ceil(c1 / BN));
// fold form (c2 > 0, n == groups * n2): grid (n2 * ceil(h*w / BM),
// ceil(cin / BN))
__global__ void __launch_bounds__(NT, 3) conv_dx_kernel(Conv p) {
  __shared__ __align__(16) float As[BK * AS];
  __shared__ __align__(16) float Bs[BK * BN];
  extern __shared__ int ktab[];  // [K]: dynamic, sized at launch
  __shared__ int prow[BM], pcol[BM];
  const int tid = threadIdx.x, tm = tid / 8, tn = tid % 8;
  const int HW = p.h * p.w, K = 9 * p.o, per = p.n / p.groups;
  const int tpi = tiles_per_image(HW);
  const int img0 = blockIdx.x / tpi, rem = (blockIdx.x % tpi) * BM;
  const int nb = blockIdx.y * BN;
  const bool fold = p.c2 > 0;
  fill_ktab(ktab, K, p.o, tid);
  fill_pixels(prow, pcol, rem, p.w, HW, tid);
  __syncthreads();

  float acc2[4][4] = {};  // fold: the x2 cotangent summed over the S images
  float s[4] = {}, q[4] = {};
  const int reps = fold ? p.groups : 1;
  for (int r = 0; r < reps; ++r) {
    const int img = fold ? r * per + img0 : img0;
    const int g = img / per;
    float acc[4][4] = {};
    for (int k0 = 0; k0 < K; k0 += BK) {
      load_tiles<true>(p, Lerp{}, img, g, k0, K, nb, ktab, prow, pcol, As, Bs, tid);
      __syncthreads();
      tile_fma(As, Bs, tm, tn, acc);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = rem + tm * 4 + i;
      const int64_t pix = (int64_t)img * HW + min(m, HW - 1);
      const float live = m < HW ? 1.f : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = nb + tn * 4 + j;
        const float d = acc[i][j];
        if (c < p.c1) {
          if (p.prologue) {
            const float sc = p.sc[g * p.c1 + c], sh = p.sh[g * p.c1 + c];
            const float xv = bf2f(p.x1[pix * p.c1 + c]);
            const float da = __fadd_rn(__fmul_rn(xv, sc), sh) > 0.f ? d : 0.f;
            p.y[pix * p.c1 + c] = f2bf(__fmul_rn(da, sc));
            s[j] = fmaf(da * live, xv, s[j]);
            q[j] += da * live;
          } else {
            p.y[pix * p.c1 + c] = f2bf(d);
          }
        } else if (c < p.c1 + p.c2) {
          acc2[i][j] += bf2f(f2bf(d));
        }
      }
    }
  }
  if (fold) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t pix2 = (int64_t)img0 * HW + min(rem + tm * 4 + i, HW - 1);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = nb + tn * 4 + j;
        if (c >= p.c1 && c < p.c1 + p.c2)
          p.y2[pix2 * p.c2 + c - p.c1] = f2bf(acc2[i][j]);
      }
    }
  }
  if (p.prologue) {
    const float cs = column_sum(As, s, tm, tn, tid);
    const float cq = column_sum(As, q, tm, tn, tid);
    if (tid < BN && nb + tid < p.c1) {
      p.p0[blockIdx.x * (int64_t)p.c1 + nb + tid] = cs;
      p.p1[blockIdx.x * (int64_t)p.c1 + nb + tid] = cq;
    }
  }
}

// grid (chunks, ceil(9*cin / BM) * ceil(o / BN), groups): block (chunk, tile,
// g) sums its chunk of group g's pixels into p0[g][chunk][9*cin][o]
template <bool X2H>
__global__ void __launch_bounds__(NT) conv_dw_kernel(Conv p, Lerp l) {
  __shared__ __align__(16) float As[BK * AS];
  __shared__ __align__(16) float Bs[BK * BN];
  extern __shared__ int ktab[];  // [K]: dynamic, sized at launch
  __shared__ int pimg[BK], prow[BK], pcol[BK];
  const int tid = threadIdx.x, tm = tid / 8, tn = tid % 8;
  const int cin = p.c1 + p.c2, M = 9 * cin, HW = p.h * p.w;
  const int ntiles = (p.o + BN - 1) / BN;
  const int mb = (blockIdx.y / ntiles) * BM, nb = (blockIdx.y % ntiles) * BN;
  const int g = blockIdx.z, chunk = blockIdx.x;
  const int64_t gsize = (int64_t)(p.n / p.groups) * HW;
  const int64_t kbeg = g * gsize + (int64_t)chunk * p.chunk;
  const int64_t kend = min(kbeg + p.chunk, (g + 1) * gsize);
  fill_ktab(ktab, M, cin, tid);

  float acc[4][4] = {};
  for (int64_t k0 = kbeg; k0 < kend; k0 += BK) {
    if (tid < BK) {
      const int64_t pix = k0 + tid;
      int img = -1, i = 0, j = 0;
      if (pix < kend) {
        img = (int)(pix / HW);
        const int q = (int)(pix - (int64_t)img * HW);
        i = q / p.w;
        j = q - i * p.w;
      }
      pimg[tid] = img;
      prow[tid] = i;
      pcol[tid] = j;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < BM * BK / NT; ++r) {
      const int e = tid + r * NT, mm = e % BM, kk = e / BM, m = mb + mm;
      float v = 0.f;
      if (m < M && pimg[kk] >= 0) {
        const int code = ktab[m];
        v = gather_z<X2H>(p, l, pimg[kk], g, prow[kk], pcol[kk], code >> 16,
                          code & 0xffff);
      }
      As[kk * AS + mm] = v;
    }
#pragma unroll
    for (int r = 0; r < BK * BN / NT; ++r) {
      const int e = tid + r * NT, nn = e % BN, kk = e / BN, n = nb + nn;
      Bs[kk * BN + nn] = (n < p.o && pimg[kk] >= 0)
                             ? bf2f(p.g[(k0 + kk) * p.o + n]) : 0.f;
    }
    __syncthreads();
    tile_fma(As, Bs, tm, tn, acc);
    __syncthreads();
  }
  float* out = p.p0 + ((int64_t)g * p.chunks + chunk) * M * p.o;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = mb + tm * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = nb + tn * 4 + j;
      if (m < M && n < p.o) out[(int64_t)m * p.o + n] = acc[i][j];
    }
  }
}

inline bool small(int64_t v) { return v >= 0 && v <= 0x3fffffff; }

// shape rules shared by the three entries
int check(int64_t n, int64_t h, int64_t w, int64_t c1, int64_t c2, int64_t n2,
          int64_t o, int64_t groups) {
  if (n <= 0 || h < 3 || w < 3 || c1 <= 0 || c2 < 0 || o <= 0 || groups <= 0 ||
      n % groups || !small(h * w) || !small(n * ((h * w + BM - 1) / BM)) ||
      c1 + c2 > 0xffff)
    return (int)cudaErrorInvalidValue;
  if (c2 > 0 && (n2 <= 0 || n % n2)) return (int)cudaErrorInvalidValue;
  return 0;
}

// x2_half_h needs x2, no prologue, an even h >= 4 and the lerp tables
bool bad_half(int64_t x2h, int64_t c2, int64_t h, int64_t prologue,
              const void* lo_h, const void* fa, const void* fb) {
  return x2h && (c2 <= 0 || prologue || h % 2 || h < 4 || !lo_h || !fa || !fb);
}

// dynamic shared memory of the ktab of a 9 x ``c`` gathered dimension
size_t ktab_bytes(int64_t c) { return (size_t)(9 * c) * sizeof(int); }

Lerp lerp_tables(const void* lo_h, const void* fa, const void* fb) {
  return Lerp{(const int*)lo_h, (const float*)fa, (const float*)fb};
}

}  // namespace

extern "C" int mimo_conv3x3_fwd(const void* x1, const void* x2, const void* w,
                                const void* sc, const void* sh, const void* lo_h,
                                const void* fa, const void* fb, void* y,
                                void* psum, void* psq, int64_t n, int64_t h,
                                int64_t wd, int64_t c1, int64_t c2, int64_t n2,
                                int64_t o, int64_t groups, int64_t prologue,
                                int64_t x2_half_h, void* stream) {
  if (int e = check(n, h, wd, c1, c2, n2, o, groups)) return e;
  if (9 * (c1 + c2) > KMAX || (prologue && c2 > 0) ||
      bad_half(x2_half_h, c2, h, prologue, lo_h, fa, fb))
    return (int)cudaErrorInvalidValue;
  Conv p = {};
  p.x1 = (const bf16*)x1;
  p.x2 = (const bf16*)x2;
  p.wgt = (const bf16*)w;
  p.sc = (const float*)sc;
  p.sh = (const float*)sh;
  p.y = (bf16*)y;
  p.p0 = (float*)psum;
  p.p1 = (float*)psq;
  p.n = (int)n; p.h = (int)h; p.w = (int)wd; p.c1 = (int)c1; p.c2 = (int)c2;
  p.n2 = c2 > 0 ? (int)n2 : 1; p.o = (int)o; p.groups = (int)groups;
  p.prologue = prologue != 0;
  p.np = (int)((o + BN - 1) / BN * BN);
  const dim3 grid((unsigned)(n * ((h * wd + BM - 1) / BM)),
                  (unsigned)((o + BN - 1) / BN));
  const Lerp l = lerp_tables(lo_h, fa, fb);
  if (x2_half_h)
    conv_fwd_kernel<true><<<grid, NT, ktab_bytes(c1 + c2), (cudaStream_t)stream>>>(p, l);
  else
    conv_fwd_kernel<false><<<grid, NT, ktab_bytes(c1 + c2), (cudaStream_t)stream>>>(p, l);
  return (int)cudaGetLastError();
}

extern "C" int mimo_conv3x3_dx(const void* g, const void* wt, const void* x1,
                               const void* sc, const void* sh, void* dx1,
                               void* dx2, void* pdsc, void* pdsh, int64_t n,
                               int64_t h, int64_t wd, int64_t o, int64_t c1,
                               int64_t c2, int64_t n2, int64_t groups,
                               int64_t prologue, void* stream) {
  if (int e = check(n, h, wd, c1, c2, n2, o, groups)) return e;
  if (9 * o > KMAX || (prologue && c2 > 0) || (c2 > 0 && n != groups * n2))
    return (int)cudaErrorInvalidValue;
  Conv p = {};
  p.g = (const bf16*)g;
  p.wgt = (const bf16*)wt;
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
  p.np = (int)((c1 + c2 + BN - 1) / BN * BN);
  const int64_t images = c2 > 0 ? n2 : n;
  const dim3 grid((unsigned)(images * ((h * wd + BM - 1) / BM)),
                  (unsigned)((c1 + c2 + BN - 1) / BN));
  conv_dx_kernel<<<grid, NT, ktab_bytes(o), (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int mimo_conv3x3_dw(const void* x1, const void* x2, const void* g,
                               const void* sc, const void* sh, const void* lo_h,
                               const void* fa, const void* fb, void* partial,
                               int64_t n, int64_t h, int64_t wd, int64_t c1,
                               int64_t c2, int64_t n2, int64_t o,
                               int64_t groups, int64_t prologue,
                               int64_t x2_half_h, int64_t chunk, void* stream) {
  if (int e = check(n, h, wd, c1, c2, n2, o, groups)) return e;
  if (9 * (c1 + c2) > KMAX || (prologue && c2 > 0) || chunk <= 0 || !small(chunk) ||
      bad_half(x2_half_h, c2, h, prologue, lo_h, fa, fb))
    return (int)cudaErrorInvalidValue;
  const int64_t gsize = n / groups * h * wd;
  const int64_t chunks = (gsize + chunk - 1) / chunk;
  Conv p = {};
  p.x1 = (const bf16*)x1;
  p.x2 = (const bf16*)x2;
  p.g = (const bf16*)g;
  p.sc = (const float*)sc;
  p.sh = (const float*)sh;
  p.p0 = (float*)partial;
  p.n = (int)n; p.h = (int)h; p.w = (int)wd; p.c1 = (int)c1; p.c2 = (int)c2;
  p.n2 = c2 > 0 ? (int)n2 : 1; p.o = (int)o; p.groups = (int)groups;
  p.prologue = prologue != 0;
  p.chunk = (int)chunk;
  p.chunks = (int)chunks;
  const int64_t tiles = (9 * (c1 + c2) + BM - 1) / BM * ((o + BN - 1) / BN);
  if (chunks > 0x7fffffff || tiles > 65535 || groups > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)chunks, (unsigned)tiles, (unsigned)groups);
  const Lerp l = lerp_tables(lo_h, fa, fb);
  if (x2_half_h)
    conv_dw_kernel<true><<<grid, NT, ktab_bytes(c1 + c2), (cudaStream_t)stream>>>(p, l);
  else
    conv_dw_kernel<false><<<grid, NT, ktab_bytes(c1 + c2), (cudaStream_t)stream>>>(p, l);
  return (int)cudaGetLastError();
}
