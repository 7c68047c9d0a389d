// Staging runs of bf16 elements through shared memory as 16-byte units:
// the memory-bound kernels' tiles (train_elem.cu's staged backward,
// upsample2x.cu).  Include after ptx.cuh (cp_async16); the CPU emulation
// of the tests puts its own stand-in of ptx.cuh first.
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
