#!/usr/bin/env python3
"""Where the fused DoubleConv kernel (K1/K2) spends its time, on one GPU.

    python3 tools/fused_tc_phases.py

Builds a copy of ``mimo_unet_torch/csrc/fused_double_conv.cu`` with
``clock64()`` counters around each phase of ``fused_double_conv_tc``
(the block's first staging; per step: copy issue, the mma loop, the
conv1/conv2 pass epilogues into the mid or the output tile, wait and
barrier, the next slice's repack and barrier; per tile: the final stores,
the next tile's first repack with its barriers) into a
library of its own under the git-ignored ``mimo_unet_torch/_build/``,
runs the kernel at the flagship serving sites of ``chip_smoke.py``
phase 3 with the wrapper's default plans, and prints each site's time
and its cycles per warp by phase with their shares.  The counters cost a
few per cent; the shares, not the times, are what the script is for.
Exits non-zero without CUDA.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LABELS = ("first staging", "issue", "mma", "pass epilogue", "wait+barrier",
          "repack+barrier", "final stores", "next tile's repack")
NPHASE = len(LABELS) + 1  # the last counts warps


def _sub(s: str, old: str, new: str) -> str:
    if s.count(old) != 1:
        raise RuntimeError(f"phase anchor not found once in the source: {old!r}")
    return s.replace(old, new)


def instrumented(src: str) -> str:
    """The kernel source with per-warp phase counters summed into a device
    array ``g_phase`` and an entry ``mimo_phase`` that resets or reads it."""
    s = _sub(src, "namespace {\n\nconstexpr int NTH_MAX",
             "__device__ unsigned long long g_phase[NPHASE];\n"
             "namespace {\n\nconstexpr int NTH_MAX")
    s = _sub(s, "  zero_pads(p, sm);\n",
             "  long long ph[NPHASE] = {};\n  long long q0 = clock64();\n"
             "  zero_pads(p, sm);\n")
    s = _sub(s, "  float acc[MTW][NTW][4];\n  int buf = 0;",
             "  float acc[MTW][NTW][4];\n  ph[0] += clock64() - q0;\n  int buf = 0;")
    s = _sub(s, "    for (int s = 0; s < steps; ++s, buf ^= 1) {\n",
             "    for (int s = 0; s < steps; ++s, buf ^= 1) {\n      long long q1 = clock64();\n")
    s = _sub(s, "      cp_async_commit();\n      if (ks == 0) {",
             "      cp_async_commit();\n      long long q2 = clock64(); ph[1] += q2 - q1;\n"
             "      if (ks == 0) {")
    for conv, ncs in (("conv1_step(p, b, sm, wb, pass, warp, lane, acc);", "p.ncs"),
                      ("conv2_step(p, b, sm, wb, pass, ks, warp, lane, acc);", "p.ncs2")):
        store = "conv1_store" if "conv1" in conv else "conv2_store"
        old = (f"        {conv}\n"
               f"        if (ks == {ncs} - 1) {store}(p, b, sm, pass, warp, lane, acc);\n")
        s = _sub(s, old, f"        {conv}\n"
                 "        long long q3 = clock64(); ph[2] += q3 - q2;\n"
                 f"        if (ks == {ncs} - 1) {store}(p, b, sm, pass, warp, lane, acc);\n"
                 "        ph[3] += clock64() - q3;\n")
    s = _sub(s, "      cp_async_wait_all();\n      __syncthreads();\n      if (restage(s + 1)) {\n"
                "        repack_slice<X2H>(p, b, sm, (s + 1) % p.ncs);\n        __syncthreads();\n"
                "      }\n    }\n",
             "      long long q4 = clock64();\n"
             "      cp_async_wait_all();\n      __syncthreads();\n"
             "      long long q5 = clock64(); ph[4] += q5 - q4;\n      if (restage(s + 1)) {\n"
             "        repack_slice<X2H>(p, b, sm, (s + 1) % p.ncs);\n        __syncthreads();\n"
             "      }\n      ph[5] += clock64() - q5;\n    }\n    long long q6 = clock64();\n")
    s = _sub(s, "    repack_first<X2H>(p, b, sm);\n    __syncthreads();\n  }\n}\n",
             "    repack_first<X2H>(p, b, sm);\n    __syncthreads();\n"
             "    ph[7] += clock64() - q7;\n  }\n"
             "  if ((threadIdx.x & 31) == 0) {\n"
             "    for (int k = 0; k < NPHASE - 1; ++k)\n"
             "      atomicAdd(&g_phase[k], (unsigned long long)ph[k]);\n"
             "    atomicAdd(&g_phase[NPHASE - 1], 1ull);\n  }\n}\n")
    s = _sub(s, "    if (!more) break;\n", "    long long q7 = clock64(); ph[6] += q7 - q6;\n"
             "    if (!more) break;\n")
    return f"#define NPHASE {NPHASE}\n" + s + '''
extern "C" int mimo_phase(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long z[NPHASE] = {};
    return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(unsigned long long) * NPHASE);
}
'''


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("fused_tc_phases: CUDA is not available")
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from conv_tc_phases import load_instrumented

    lib = load_instrumented("fused_double_conv", instrumented, "fused_phases")

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    sites = [st for st in cs.eval_sites(dev, torch.Generator(device=dev).manual_seed(0))
             if st.fdc is not None]
    buf = (ctypes.c_ulonglong * NPHASE)()
    for st in sites:
        st.kern()
        torch.cuda.synchronize()
        lib.mimo_phase(None, 1)
        ms = cs.cuda_ms(st.kern, 5)
        lib.mimo_phase(buf, 0)
        v = list(buf)
        cyc = [v[k] / max(v[-1], 1) for k in range(len(LABELS))]
        total = sum(cyc) or 1.0
        print(f"{st.name} [{st.site}]: {ms:.4f} ms; cycles per warp "
              + ", ".join(f"{lab} {c:.0f} ({100 * c / total:.0f} %)"
                          for lab, c in zip(LABELS, cyc)) + f" ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
