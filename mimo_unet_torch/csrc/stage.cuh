// Staging runs of bf16 elements through shared memory as 16-byte units:
// the memory-bound kernels' tiles (train_elem.cu's staged 1x1 kernels,
// upsample2x.cu, upsample_w2x.cu's forward).  Include after ptx.cuh
// (cp_async16); the CPU emulation of the tests puts its own stand-in of
// ptx.cuh first.
#pragma once

#include "common.cuh"

// 16-byte units that hold px runs of k bf16 from any element offset
__host__ __device__ __forceinline__ int units_of(int px, int k) {
  return (px * k + 7) / 8 + 1;
}

// copy elements [e0, e1) of src (tot elements) into dst as the 16-byte
// units that hold them: dst[i] = src[8 * (e0 / 8) + i], so element e lands
// at dst[e - 8 * (e0 / 8)].  Whole units by cp.async where src is 16-byte
// aligned (vec), the tensor's ragged end and an unaligned src by ld8.
// Threads tid of nthr share the units.
__device__ __forceinline__ void stage_units(bf16* dst, const bf16* src, int64_t e0,
                                            int64_t e1, int64_t tot, int vec, int tid,
                                            int nthr) {
  const int64_t u0 = e0 >> 3;
  const int n = (int)(((e1 + 7) >> 3) - u0);
  for (int i = tid; i < n; i += nthr) {
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
                                            int64_t e1, int vec, int tid, int nthr) {
  const int64_t u0 = e0 >> 3;
  const int n = (int)(((e1 + 7) >> 3) - u0);
  for (int i = tid; i < n; i += nthr) {
    const int64_t e = (u0 + i) * 8;
    if (vec && e >= e0 && e + 8 <= e1) {
      *reinterpret_cast<uint4*>(dst + e) = *reinterpret_cast<const uint4*>(src + 8 * i);
    } else {
      for (int k = 0; k < 8; ++k)
        if (e + k >= e0 && e + k < e1) dst[e + k] = src[8 * i + k];
    }
  }
}

// elements [e, e + 8) of dst from v (rounded to bf16): one 16-byte store
// where vec and the unit lies whole and aligned before end, else element
// by element up to end
__device__ __forceinline__ void store8(bf16* dst, int64_t e, int64_t end, const float v[8],
                                       int vec) {
  if (vec && (e & 7) == 0 && e + 8 <= end) {
    st8(dst + e, v);
  } else {
    for (int i = 0; i < 8 && e + i < end; ++i) dst[e + i] = f2bf(v[i]);
  }
}

// te and the number of tiles of a row of len elements cut into tiles of
// at most cap elements, as even as they go (te a multiple of 8)
static inline int cut_row(int len, int cap, int* tiles) {
  *tiles = (len + cap - 1) / cap;
  return ((len + *tiles - 1) / *tiles + 7) & ~7;
}
