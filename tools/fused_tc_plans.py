#!/usr/bin/env python3
"""Time the fused DoubleConv kernel (K1/K2, ``csrc/fused_double_conv.cu``)
at its flagship serving sites under each launch plan it could take
(``fused_double_conv.plans``): output tiles 8x16, 16x16 and 8x32, each
with the widest channel slices that leave room for two blocks a
multiprocessor and with those that fit one.

    python3 tools/fused_tc_plans.py

Run from the root of the repository on a CUDA card.  Builds the kernels,
prints ptxas's report and the HMMA count of the tensor-core kernels
(``chip_smoke.tensor_core_report``), then for each site of
``chip_smoke.eval_sites`` (S=2, fbc=21, 256x256, B=32) and each plan: the
plan, its error against the plain version (phase 3's tolerance, and
bitwise from one launch to the next) and its time (CUDA events, mean of 5
calls after a warm-up, the weight packing of each call included, as the
wrapper does it).  The default plan (``plan_of``'s) is marked.  Every time carries the card's name and power limit.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("fused_tc_plans: CUDA is not available")
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from mimo_unet_torch.kernels import _build
    fdc = importlib.import_module("mimo_unet_torch.kernels.fused_double_conv")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.load_library()
    cs.tensor_core_report()
    sites = [st for st in cs.eval_sites(dev, torch.Generator(device=dev).manual_seed(0))
             if st.fdc is not None]
    for st in sites:
        x1, dc, kw = st.fdc
        x2 = kw.get("x2")
        c1, c2 = x1.shape[-1], 0 if x2 is None else x2.shape[-1]
        m, o = dc[0].shape[4], dc[3].shape[4]
        want = st.plain()
        default = fdc.plan_of(c1, c2, m, o)
        firsts = {}
        for plan in fdc.plans(c1, c2, m, o):  # the widest slices of each entry
            firsts.setdefault((plan.smem <= fdc.SMEM_TWO, plan.th, plan.tw, plan.warps), plan)
        for plan in firsts.values():

            def run(plan=plan):
                _, args, (out, hp), _keep = fdc.kernel_args(
                    x1, *dc, x2, kw.get("x2_half_h", False), kw.get("wo"),
                    kw.get("bo"), kw.get("emit_hpool", False),
                    kw.get("group_rows_out", False), plan=plan)
                _build.launch("mimo_fused_double_conv", dev, *args)
                return (out, hp) if hp is not None else out

            got = run()
            torch.cuda.synchronize()
            err = cs.compare(f"{st.site} {plan}", got, want, False)
            cs.compare(f"{st.site} {plan} launch to launch", run(), got, True)
            ms = cs.cuda_ms(run, 5)
            mark = " (default)" if plan == default else ""
            print(f"{st.site}: {plan}{mark}: {ms:.4f} ms, max_abs_err {err} ({card})",
                  flush=True)
        del want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
