#!/usr/bin/env python3
"""K12's and K11's forward (``conv1x1_prelu``: BatchNorm affine, ReLU and
the 1x1 out-conv; ``conv1x1``: the out-conv alone) across channel counts
and out-conv widths, on one GPU, optionally against an earlier
``train_elem.cu``.

    python3 tools/k12_widths.py [OLD_TRAIN_ELEM_CU]

At the 640x480 B=4 train site's pixel count (N = 4 images, one group) it
calls each forward for C in CHANNELS and OC in OUTS, holds it within
``chip_smoke.compare``'s tolerance of its plain version and bitwise
against its own second launch, and prints its time
(``chip_smoke.cuda_ms``: device time of 20 calls queued behind a
device-side wait) with its share of the byte bound (y read once, the
logits written once) and the card's name and power limit.  Given
OLD_TRAIN_ELEM_CU (for example the parent commit's, unpacked with ``git
archive`` into the git-ignored ``build/``; its headers beside it), it
builds that library too (``tools/train_elem_ab.py``
``variant_libraries``), holds the new output bitwise against the old and
times old, new, new, old.  It shows how the forwards' time depends on C
and OC, e.g. at the evidential decoder's C = 32, OC = 4 against the
flagship's C = 21, OC = 2.  Exits non-zero without CUDA.
"""

from __future__ import annotations

import glob
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHANNELS = (16, 21, 24, 31, 32, 33, 40, 48, 64)
OUTS = (2, 4)
N, H, W = 4, 480, 640


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k12_widths: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import chip_smoke as cs
    from mimo_unet_torch import kernels as K
    from mimo_unet_torch.kernels import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    libs = {"new": _build.load_library()}
    if len(sys.argv) > 1:
        from train_elem_ab import variant_libraries

        old = os.path.abspath(sys.argv[1])
        files = {}
        for path in [old] + glob.glob(os.path.join(os.path.dirname(old), "*.cuh")):
            with open(path, "rb") as f:
                files[os.path.basename(path)] = f.read()
        files["train_elem.cu"] = files.pop(os.path.basename(old))
        libs.update(variant_libraries({"old": files}))
    order = ("old", "new", "new", "old") if "old" in libs else ("new",)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for oc in OUTS:
        for c in CHANNELS:
            y = (torch.randn((N, H, W, c), device=dev, generator=gen) * 3).to(torch.bfloat16)
            sc = torch.rand((1, c), device=dev, generator=gen) + 0.5
            sh = torch.randn((1, c), device=dev, generator=gen) * 0.1
            wo = (torch.rand((1, c, oc), device=dev, generator=gen) * 2 - 1) / c ** 0.5
            bo = torch.randn((1, oc), device=dev, generator=gen) * 0.1
            for name, call, plain in (
                    ("K12", lambda: K.conv1x1_prelu(y, sc, sh, wo, bo),
                     lambda: K.conv1x1_prelu_plain(y, sc, sh, wo, bo)),
                    ("K11", lambda: K.conv1x1(y, wo, bo), lambda: K.conv1x1_plain(y, wo, bo))):
                outs = {}
                for which in libs:
                    _build._lib = libs[which]
                    outs[which] = call()
                    torch.cuda.synchronize()
                    cs.compare(f"{name} C={c} OC={oc} [{which}]", outs[which], plain(), False)
                    cs.compare(f"{name} C={c} OC={oc} [{which}] launch to launch", call(),
                               outs[which], True)
                if "old" in outs:
                    cs.compare(f"{name} C={c} OC={oc} new vs old", outs["new"], outs["old"],
                               True)
                times = {w: [] for w in libs}
                for which in order:
                    _build._lib = libs[which]
                    times[which].append(cs.cuda_ms(call, 20))
                bound = 2.0 * N * H * W * (c + oc) / cs.PEAK_BYTES * 1e3
                print(f"{name} forward C={c:3d} OC={oc}: " + ", ".join(
                    f"{w} {sum(t) / len(t):.4f} ms ({100 * bound * len(t) / sum(t):.0f} %; "
                    f"turns {[round(x, 4) for x in t]})" for w, t in times.items())
                    + f", bound {bound:.4f} ms ({card})", flush=True)
    _build._lib = libs["new"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
