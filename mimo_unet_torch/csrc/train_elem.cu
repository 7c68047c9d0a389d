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
//     :494).  The same kernels as conv1x1_prelu without the prologue (the
//     template flag PRO).
//   * mimo_reduce_groups: the second pass of every per-block reduction of
//     the train kernels (these and conv3x3_train.cu): out[g] = sum of the
//     group's partials, in a fixed order.
//
// What bounds them on the H100: device-memory bytes.  Each element takes a
// few flops against 2-6 bytes read and 2 written.  Design: the pure maps
// are one grid-stride pass; the passes with channel reductions give each
// block 256 pixels of one group (a group's last block takes what is left
// when 256 does not divide its pixel count) and a 32 x 8 thread layout,
// channel x pixel lane, so a warp reads
// a pixel's channels contiguously and each thread keeps its channel's sums
// in registers; the eight lanes then combine in shared memory in a fixed
// order and the block writes one partial per channel.  No atomics: results
// do not change from run to run.
#include "common.cuh"

namespace {

constexpr int PB = 256;   // pixels per block of the reducing passes
constexpr int CMAX = 128;  // channels the 1x1 convs take (their shared tables)
constexpr int OCMAX = 8;  // out-conv channels

__device__ __forceinline__ float affine(float y, float s, float b) {
  return __fadd_rn(__fmul_rn(y, s), b);
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

__global__ void g_eff_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ y,
                             const float* __restrict__ ds, const float* __restrict__ dq,
                             bf16* __restrict__ out, int64_t total,
                             int64_t group_elems, int o) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const int c = (int)(e % o);
    const int64_t k = (e / group_elems) * o + c;
    out[e] = f2bf(__fadd_rn(__fadd_rn(bf2f(dy[e]), ds[k]),
                            __fmul_rn(2.f * bf2f(y[e]), dq[k])));
  }
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

// block (32, 8): channel lane x pixel lane; grid groups * ceil(group pixels
// / PB).  Partial row of
// a block: [dwo (c*oc), dbo (oc)] and with PRO [dscale (c), dshift (c)].
template <bool PRO>
__global__ void __launch_bounds__(256) conv1x1_bwd_kernel(
    const bf16* __restrict__ gout, const bf16* __restrict__ y,
    const float* __restrict__ sc, const float* __restrict__ sh,
    const bf16* __restrict__ wo, bf16* __restrict__ dy,
    float* __restrict__ partial, int64_t group_pixels, int c, int oc) {
  __shared__ float red[8 * 32];
  const Span sp = block_span(group_pixels);
  const int g = sp.g;
  const int L = c * oc + oc + (PRO ? 2 * c : 0);
  float* prow = partial + blockIdx.x * (int64_t)L;
  for (int c0 = 0; c0 < c; c0 += 32) {
    const int ch = c0 + threadIdx.x;
    const bool live = ch < c;
    float w[OCMAX] = {}, dwo[OCMAX] = {}, dbo[OCMAX] = {};
    float scv = 0.f, shv = 0.f, s = 0.f, q = 0.f;
    if (live) {
      if constexpr (PRO) {
        scv = sc[g * c + ch];
        shv = sh[g * c + ch];
      }
      for (int k = 0; k < oc; ++k) w[k] = bf2f(wo[((int64_t)g * c + ch) * oc + k]);
    }
    for (int pp = threadIdx.y; pp < sp.count; pp += 8) {
      const int64_t pix = sp.pix0 + pp;
      float gk[OCMAX];
#pragma unroll
      for (int k = 0; k < OCMAX; ++k) gk[k] = k < oc ? bf2f(gout[pix * oc + k]) : 0.f;
      if (c0 == 0 && threadIdx.x == 0)
#pragma unroll
        for (int k = 0; k < OCMAX; ++k) dbo[k] += gk[k];
      if (!live) continue;
      const float yv = bf2f(y[pix * c + ch]);
      float a = 0.f, z = yv;
      if constexpr (PRO) {
        a = affine(yv, scv, shv);
        z = bf2f(f2bf(a > 0.f ? a : 0.f));
      }
      float dz = 0.f;
#pragma unroll
      for (int k = 0; k < OCMAX; ++k) {
        dz = fmaf(w[k], gk[k], dz);
        dwo[k] = fmaf(z, gk[k], dwo[k]);
      }
      if constexpr (PRO) {
        const float da = a > 0.f ? dz : 0.f;
        dy[pix * c + ch] = f2bf(__fmul_rn(da, scv));
        s = fmaf(da, yv, s);
        q += da;
      } else {
        dy[pix * c + ch] = f2bf(dz);
      }
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
    if constexpr (PRO) {
      s = lane_sum(red, s);
      q = lane_sum(red, q);
      if (threadIdx.y == 0 && live) {
        prow[c * oc + oc + ch] = s;
        prow[c * oc + oc + c + ch] = q;
      }
    }
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

// blocks of a reducing pass: ceil(group pixels / PB) per group
unsigned reducing_blocks(int64_t n, int64_t hw, int64_t groups) {
  return (unsigned)(groups * ((n / groups * hw + PB - 1) / PB));
}

}  // namespace

extern "C" int mimo_g_eff(const void* dy, const void* y, const void* dsum,
                          const void* dsumsq, void* out, int64_t n, int64_t hw,
                          int64_t o, int64_t groups, void* stream) {
  if (n <= 0 || hw <= 0 || o <= 0 || groups <= 0 || n % groups) return bad();
  const int64_t total = n * hw * o;
  g_eff_kernel<<<elementwise_blocks(total, 256), 256, 0, (cudaStream_t)stream>>>(
      (const bf16*)dy, (const bf16*)y, (const float*)dsum, (const float*)dsumsq,
      (bf16*)out, total, n / groups * hw * o, (int)o);
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

template <bool PRO>
int conv1x1_bwd_launch(const void* g, const void* y, const void* sc,
                       const void* sh, const void* wo, void* dy, void* partial,
                       int64_t n, int64_t hw, int64_t c, int64_t oc,
                       int64_t groups, void* stream) {
  if (bad_1x1(n, hw, c, oc, groups)) return bad();
  conv1x1_bwd_kernel<PRO><<<reducing_blocks(n, hw, groups), dim3(32, 8), 0,
                            (cudaStream_t)stream>>>(
      (const bf16*)g, (const bf16*)y, (const float*)sc, (const float*)sh,
      (const bf16*)wo, (bf16*)dy, (float*)partial, n / groups * hw, (int)c,
      (int)oc);
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
  return conv1x1_bwd_launch<true>(g, y, sc, sh, wo, dy, partial, n, hw, c, oc,
                                  groups, stream);
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
  return conv1x1_bwd_launch<false>(g, z, nullptr, nullptr, wo, dz, partial, n,
                                   hw, c, oc, groups, stream);
}

extern "C" int mimo_reduce_groups(const void* partial, void* out, int64_t groups,
                                  int64_t p, int64_t l, void* stream) {
  if (groups <= 0 || groups > 65535 || p <= 0 || l <= 0) return bad();
  const dim3 grid((unsigned)((l + 31) / 32), (unsigned)groups);
  reduce_groups_kernel<<<grid, dim3(32, 16), 0, (cudaStream_t)stream>>>(
      (const float*)partial, (float*)out, p, l);
  return (int)cudaGetLastError();
}
