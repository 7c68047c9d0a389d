#!/usr/bin/env python3
"""K12's backward (``conv1x1_prelu_bwd``) under other tile sizes and
blocks an SM, on one GPU.

    python3 tools/prelu_bwd_sweep.py

Builds copies of ``mimo_unet_torch/csrc/train_elem.cu`` with
``K12_TILE_BYTES`` and ``K12_PER_SM`` set to each pair of the sweep (a
library each, under the git-ignored ``mimo_unet_torch/_build/``), runs
K12's backward through its wrapper (the partial rows follow the same
constants) at the 256x256 B=64 sites (groups 2 and 128) and the 640x480
B=4 site of ``chip_smoke.py``, holds dy bitwise against the source's own
constants and the sums against the plain version, and prints each
variant's time (CUDA events, 20 launches after a warm-up).  How
``K12_TILE_BYTES`` and ``K12_PER_SM`` were chosen.  Exits non-zero
without CUDA.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEP = [(t, b) for t in (4096, 8192, 16384) for b in (3, 4, 5)]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("prelu_bwd_sweep: CUDA is not available")
    sys.path[:0] = [REPO, os.path.join(REPO, "tools")]
    import chip_smoke as cs
    from train_elem_ab import sites, variant_library
    from mimo_unet_torch import kernels as K
    from mimo_unet_torch.kernels import _build
    from mimo_unet_torch.kernels import train_elem as TE

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    src = (_build.CSRC_DIR / "train_elem.cu").read_text()
    base = _build.load_library()
    libs = {}
    for tile, per_sm in SWEEP:
        v = re.sub(r"(constexpr int K12_TILE_BYTES = )\d+;", rf"\g<1>{tile};", src)
        v = re.sub(r"(constexpr int K12_PER_SM = )\d+;", rf"\g<1>{per_sm};", v)
        libs[tile, per_sm] = variant_library(v.encode())
    dev = torch.device("cuda", 0)
    k12 = [s for s in sites(dev, torch.Generator(device=dev).manual_seed(12))
           if s[1] == "prelu_bwd"]
    consts = TE.K12_TILE_BYTES, TE.K12_BLOCKS
    for label, _, ts in k12:
        _build._lib = base
        want = K.conv1x1_prelu_bwd(*ts)
        plain = K.conv1x1_prelu_bwd_plain(*ts)
        line = []
        for (tile, per_sm), lib in libs.items():
            _build._lib = lib
            TE.K12_TILE_BYTES, TE.K12_BLOCKS = tile, per_sm * 132
            got = K.conv1x1_prelu_bwd(*ts)
            if not torch.equal(got[0], want[0]):
                raise AssertionError(f"{label}: dy at ({tile}, {per_sm}) differs")
            cs.compare(f"{label} ({tile}, {per_sm})", got, plain, False)
            line.append(f"{tile}/{per_sm} {cs.cuda_ms(lambda: K.conv1x1_prelu_bwd(*ts), 20):.4f}")
        TE.K12_TILE_BYTES, TE.K12_BLOCKS = consts
        print(f"{label}, ms by tile bytes/blocks an SM: {', '.join(line)} ({card})",
              flush=True)
        del want, plain, got
        torch.cuda.empty_cache()
    _build._lib = base
    return 0


if __name__ == "__main__":
    sys.exit(main())
