// The PTX helpers of csrc/ptx.cuh (same names and arguments) as
// host code: cp.async as a plain copy, ldmatrix and mma.sync m16n8k16 by
// their fragment layouts (PTX ISA), each warp's lanes exchanging operands
// between two warp barriers.
inline uint32_t smem_addr(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }
inline void cp_async16(void* dst, const void* src) {
  if (((uintptr_t)src & 15) != 0 || ((uintptr_t)dst & 15) != 0)
    emu_fault("cp.async address not 16-byte aligned");
  else if (emu_check_smem(dst, 16, "cp.async destination"))
    std::memcpy(dst, src, 16);
}
inline void cp_async_commit() {}
inline void cp_async_wait_all() {}
// lane l gives row l % 8 of matrix l / 8; non-trans: lane T receives row
// T / 4, elements 2 (T % 4) and 2 (T % 4) + 1; trans: those of column T / 4
inline void emu_ldsm(uint32_t* r, uint32_t a, int nmat, bool trans) {
  EmuWarp& w = emu_warp();
  const int l = emu_tid() & 31;
  w.addr[l] = emu_block->smem + a;
  w.bar.arrive_and_wait();
  for (int i = 0; i < nmat; ++i) {
    static const uint16_t zeros[8] = {};
    auto row = [&](int j) {
      const void* p = w.addr[i * 8 + j];
      if (((uintptr_t)p & 15) != 0) {
        emu_fault("ldmatrix row not 16-byte aligned");
        return zeros;
      }
      return emu_check_smem(p, 16, "ldmatrix row") ? (const uint16_t*)p : zeros;
    };
    const uint16_t lo = trans ? row(2 * (l % 4))[l / 4] : row(l / 4)[2 * (l % 4)];
    const uint16_t hi = trans ? row(2 * (l % 4) + 1)[l / 4] : row(l / 4)[2 * (l % 4) + 1];
    r[i] = (uint32_t)lo | ((uint32_t)hi << 16);
  }
  w.bar.arrive_and_wait();
}
inline void ldsm_x4(uint32_t r[4], uint32_t a) { emu_ldsm(r, a, 4, false); }
inline void ldsm_x2(uint32_t r[2], uint32_t a) { emu_ldsm(r, a, 2, false); }
inline void ldsm_x4_t(uint32_t r[4], uint32_t a) { emu_ldsm(r, a, 4, true); }
inline void ldsm_x2_t(uint32_t r[2], uint32_t a) { emu_ldsm(r, a, 2, true); }
inline float emu_half(uint32_t r, int hi) {
  return __uint_as_float((hi ? (r >> 16) : (r & 0xffff)) << 16);
}
// d += a . b; a: a0 (row g, k 2t..), a1 (g + 8), a2 (g, k 2t + 8..), a3;
// b: b0 (k 2t.., column g), b1 (k 2t + 8..); d: rows g, g + 8, columns 2t, 2t + 1
inline void mma16816(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  EmuWarp& w = emu_warp();
  const int l = emu_tid() & 31;
  for (int k = 0; k < 4; ++k) w.a[l][k] = a[k];
  w.b[l][0] = b[0];
  w.b[l][1] = b[1];
  w.bar.arrive_and_wait();
  float A[16][16], B[16][8];
  for (int T = 0; T < 32; ++T) {
    const int g = T / 4, t = T % 4;
    for (int h = 0; h < 2; ++h) {
      A[g][2 * t + h] = emu_half(w.a[T][0], h);
      A[g + 8][2 * t + h] = emu_half(w.a[T][1], h);
      A[g][2 * t + 8 + h] = emu_half(w.a[T][2], h);
      A[g + 8][2 * t + 8 + h] = emu_half(w.a[T][3], h);
      B[2 * t + h][g] = emu_half(w.b[T][0], h);
      B[2 * t + 8 + h][g] = emu_half(w.b[T][1], h);
    }
  }
  w.bar.arrive_and_wait();
  const int g = l / 4, t = l % 4;
  for (int i = 0; i < 4; ++i) {
    const int m = g + (i >> 1) * 8, n = 2 * t + (i & 1);
    double s = d[i];
    for (int k = 0; k < 16; ++k) s += (double)A[m][k] * B[k][n];
    d[i] = (float)s;
  }
}
