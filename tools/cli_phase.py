#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 17 alone on one GPU: the reference CLIs at
the MIMO CLI's defaults (S=3, fbc 32, B=32) and SEN12TP's two input
channels, after the flagship's eval, train and resample sites that its
kernel times are printed beside.

    python3 tools/cli_phase.py

Builds the kernels, checks the flagship's sites (phases 3, 5 and 10's
lists at 256x256 B=32 eval and 640x480 B=4 train), runs
``chip_smoke.cli_phase`` and prints its kernels' JSON line.  About 5
minutes of command time.  Exits non-zero without CUDA or on any failure.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("cli_phase: CUDA is not available")
    import chip_smoke as cs
    from mimo_unet_torch.kernels import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(card, torch.__version__, torch.version.cuda, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ[cs.X2_HALF] = "0"
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda", 0)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    flag = {"eval": cs.eval_sites(dev, gen(0)),
            "train": cs._tc_marked(cs.train_sites(dev, gen(1))),
            "resample": cs.resample_sites(dev, gen(3), steps=((cs.TB, cs.NYU),))}
    cs.check_kernels(cs._redesigned([st for v in flag.values() for st in v]), card)
    flagship_sites = {k: [(st.name, st.site) for st in v] for k, v in flag.items()}
    del flag
    torch.cuda.empty_cache()
    stats, launches, stats2, launches2 = cs.cli_phase(dev, card, flagship_sites)
    rows = [{"name": f"{k} ({what})", "launches": counts[k], **st[k]}
            for what, st, counts in (("S=3 fbc 32", stats, launches),
                                     ("S=3 fbc 32 C_in 2", stats2, launches2))
            for k in cs.KERNEL_INFO if k in st]
    print(json.dumps({"kernels": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
