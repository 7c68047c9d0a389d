#!/usr/bin/env python3
"""Where the tensor-core train conv kernels spend their time, on one GPU.

    python3 tools/conv_tc_phases.py

Builds a copy of ``mimo_unet_torch/csrc/conv3x3_train.cu`` with
``clock64()`` counters around each phase of K5 (fwd: copy issue, mma
loop, epilogue with the statistics, wait and barrier, repack and
barrier), K6 (dx: copy issue, mma loop, epilogue, wait and barrier,
repack) and K7 (dw: copy issue, mma loop, wait and barrier, repack and
barrier) into a library of its own under the
git-ignored ``mimo_unet_torch/_build/``, runs them at the 640x480 B=4
call sites of ``chip_smoke.py`` phase 5, and prints each site's time and
its cycles per warp by phase with their shares.  The counters cost a few
per cent; the shares, not the times, are what the script is for.  Exits
non-zero without CUDA.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPHASE = 24  # counters: dx 0-4 and 15, dw 8-11 and 14, fwd 16-21


def _sub(s: str, old: str, new: str) -> str:
    if s.count(old) != 1:
        raise RuntimeError(f"phase anchor not found once in the source: {old!r}")
    return s.replace(old, new)


def instrumented(src: str) -> str:
    """The kernel source with per-warp phase counters summed into a device
    array ``g_phase`` (dx: 0-4, blocks' warps 15; dw: 8-11, 14; fwd: 16-20,
    21) and an entry ``mimo_phase`` that resets or reads it."""
    s = _sub(src, "namespace {\n\n// relu(x*scale + shift)",
             "__device__ unsigned long long g_phase[NPHASE];\n"
             "namespace {\n\n// relu(x*scale + shift)")
    # K5
    s = _sub(s, "  for (int t = t0; t < t1; ++t) {\n    const TileAt tl = tile_at(p, img, t);",
             "  long long ph[5] = {0, 0, 0, 0, 0};\n"
             "  for (int t = t0; t < t1; ++t) {\n    const TileAt tl = tile_at(p, img, t);")
    s = _sub(s, "      const bool last = cs + 1 == nsl;\n",
             "      const bool last = cs + 1 == nsl;\n      long long q0 = clock64();\n")
    s = _sub(s, "      if (live) fwd_compute(p, smem_addr(sm), warp, lane, cs, ntn, acc);\n",
             "      long long q1 = clock64(); ph[0] += q1 - q0;\n"
             "      if (live) fwd_compute(p, smem_addr(sm), warp, lane, cs, ntn, acc);\n"
             "      long long q2 = clock64(); ph[1] += q2 - q1;\n")
    s = _sub(s, "      cp_async_wait_all();\n      __syncthreads();\n      if (!last) {",
             "      long long q3 = clock64(); ph[2] += q3 - q2;\n"
             "      cp_async_wait_all();\n      __syncthreads();\n"
             "      long long q4 = clock64(); ph[3] += q4 - q3;\n      if (!last) {")
    s = _sub(s, "        z_repack<X2H, FWD_THREADS>(p, sm, tile_at(p, img, t + 1), 0, min(p.cb, cin), tid);\n"
                "        __syncthreads();\n      }\n    }\n  }\n",
             "        z_repack<X2H, FWD_THREADS>(p, sm, tile_at(p, img, t + 1), 0, min(p.cb, cin), tid);\n"
             "        __syncthreads();\n      }\n      ph[4] += clock64() - q4;\n    }\n  }\n"
             "  if (lane == 0) {\n    for (int k = 0; k < 5; ++k)\n"
             "      atomicAdd(&g_phase[16 + k], (unsigned long long)ph[k]);\n"
             "    atomicAdd(&g_phase[21], 1ull);\n  }\n")
    # K6
    s = _sub(s, "  for (int s = 0; s < nsteps; ++s) {\n    const TileAt tl = tile_of(s);",
             "  long long ph[5] = {0, 0, 0, 0, 0};\n"
             "  for (int s = 0; s < nsteps; ++s) {\n    long long q0 = clock64();\n"
             "    const TileAt tl = tile_of(s);")
    s = _sub(s, "      dx_fetch_g(p, sm, tile_of(s + 1), warp, lane);\n      cp_async_commit();\n    }\n",
             "      dx_fetch_g(p, sm, tile_of(s + 1), warp, lane);\n      cp_async_commit();\n    }\n"
             "    long long q1 = clock64(); ph[0] += q1 - q0; long long q2 = q1;\n")
    s = _sub(s, "                 acc);\n      const float* aff",
             "                 acc);\n      q2 = clock64(); ph[1] += q2 - q1;\n      const float* aff")
    s = _sub(s, "    cp_async_wait_all();\n    __syncthreads();\n    if (more) {\n      const int g1",
             "    long long q3 = clock64(); ph[2] += q3 - q2;\n    cp_async_wait_all();\n"
             "    __syncthreads();\n    long long q4 = clock64(); ph[3] += q4 - q3;\n"
             "    if (more) {\n      const int g1")
    s = _sub(s, "      dx_repack(p, sm, tile_of(s + 1), tid);\n      cp_async_wait_all();\n"
                "      __syncthreads();\n    }\n  }\n",
             "      dx_repack(p, sm, tile_of(s + 1), tid);\n      cp_async_wait_all();\n"
             "      __syncthreads();\n    }\n    ph[4] += clock64() - q4;\n  }\n"
             "  if (lane == 0) {\n    for (int k = 0; k < 5; ++k)\n"
             "      atomicAdd(&g_phase[k], (unsigned long long)ph[k]);\n"
             "    atomicAdd(&g_phase[15], 1ull);\n  }\n")
    # K7
    s = _sub(s, "    for (int t = t0; t < t1; ++t) {\n      const bool more = t + 1 < t1;",
             "    long long ph[4] = {0, 0, 0, 0};\n    for (int t = t0; t < t1; ++t) {\n"
             "      long long q0 = clock64();\n      const bool more = t + 1 < t1;")
    s = _sub(s, "      dw_compute(p, smem_addr(sm), warp, lane, mt_lo, mt_hi, ntn, acc);\n"
                "      cp_async_wait_all();\n      __syncthreads();\n      if (more) {\n"
                "        dw_repack<X2H>(p, sm, next, cs0, cs_n, os0, os_n, tid);\n"
                "        __syncthreads();\n      }\n    }\n",
             "      long long q1 = clock64(); ph[0] += q1 - q0;\n"
             "      dw_compute(p, smem_addr(sm), warp, lane, mt_lo, mt_hi, ntn, acc);\n"
             "      long long q2 = clock64(); ph[1] += q2 - q1;\n"
             "      cp_async_wait_all();\n      __syncthreads();\n"
             "      long long q3 = clock64(); ph[2] += q3 - q2;\n      if (more) {\n"
             "        dw_repack<X2H>(p, sm, next, cs0, cs_n, os0, os_n, tid);\n"
             "        __syncthreads();\n      }\n      ph[3] += clock64() - q3;\n    }\n"
             "    if (lane == 0) {\n      for (int k = 0; k < 4; ++k)\n"
             "        atomicAdd(&g_phase[8 + k], (unsigned long long)ph[k]);\n"
             "      atomicAdd(&g_phase[14], 1ull);\n    }\n")
    return f"#define NPHASE {NPHASE}\n" + s + '''
extern "C" int mimo_phase(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long z[NPHASE] = {};
    return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(unsigned long long) * NPHASE);
}
'''


def load_instrumented(stem: str, instrument, out_name: str) -> ctypes.CDLL:
    """Build the kernel library with ``csrc/<stem>.cu`` replaced by
    ``instrument`` of its text (headers included from ``csrc``) under the
    git-ignored ``mimo_unet_torch/_build/<out_name>``, load it with the
    entries' signatures and ``mimo_phase``, and make it the library the
    wrappers launch."""
    from mimo_unet_torch.kernels import _build

    out = _build.BUILD_DIR / out_name
    out.mkdir(parents=True, exist_ok=True)
    src = instrument((_build.CSRC_DIR / f"{stem}.cu").read_text())
    for hdr in ("common.cuh", "ptx.cuh"):
        src = src.replace(f'#include "{hdr}"', f'#include "{_build.CSRC_DIR / hdr}"')
    (out / f"{stem}.cu").write_text(src)
    nvcc = _build._nvcc()
    srcs = [out / f"{stem}.cu"] + [p for p in sorted(_build.CSRC_DIR.glob("*.cu"))
                                   if p.stem != stem]
    objs = [str(out / (p.stem + ".o")) for p in srcs]
    _build._run_all([[nvcc] + _build.NVCC_FLAGS + ["-c", str(p), "-o", o]
                     for p, o in zip(srcs, objs)])
    _build._run_all([[nvcc, "-shared", "-o", str(out / "libphases.so")] + objs])
    lib = ctypes.CDLL(str(out / "libphases.so"))
    for name, argtypes in _build._SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.mimo_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mimo_cuda_error_string.restype = ctypes.c_char_p
    lib.mimo_phase.argtypes = [ctypes.c_void_p, ctypes.c_int]
    _build._lib = lib
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("conv_tc_phases: CUDA is not available")
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    lib = load_instrumented("conv3x3_train", instrumented, "phases")

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    sites = [st for st in cs.train_sites(dev, torch.Generator(device=dev).manual_seed(1))
             if st.name in cs.TC_KERNELS]
    buf = (ctypes.c_ulonglong * NPHASE)()
    for st in sites:
        st.kern()
        torch.cuda.synchronize()
        lib.mimo_phase(None, 1)
        ms = cs.cuda_ms(st.kern, 5)  # six launches counted
        lib.mimo_phase(buf, 0)
        v = list(buf)
        if st.name == "conv3x3_dw":
            labels, first, warps = ["issue", "mma", "wait+barrier", "repack+barrier"], 8, v[14]
        elif st.name == "conv3x3_fwd":
            labels, first, warps = ["issue", "mma", "epilogue+statistics", "wait+barrier",
                                    "repack+barrier"], 16, v[21]
        else:
            labels, first, warps = ["issue", "mma", "epilogue", "wait+barrier",
                                    "repack+barrier"], 0, v[15]
        cyc = [v[first + k] / max(warps, 1) for k in range(len(labels))]
        total = sum(cyc) or 1.0
        print(f"{st.name} [{st.site}]: {ms:.4f} ms; cycles per warp "
              + ", ".join(f"{lab} {c:.0f} ({100 * c / total:.0f} %)"
                          for lab, c in zip(labels, cyc)) + f" ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
