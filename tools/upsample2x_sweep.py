#!/usr/bin/env python3
"""K13 (``upsample2x`` and its backward) under other bands and row tiles,
and with a phase left out, on one GPU.

    python3 tools/upsample2x_sweep.py

Builds copies of ``mimo_unet_torch/csrc/upsample2x.cu`` with the forward's
``UP_BAND`` (output rows a block) and the backward's ``BK_BAND`` (half rows
a block) and ``BK_TILE`` (half-row elements a block) set to each triple of
the sweep (a library each, under the git-ignored
``mimo_unet_torch/_build/``), runs K13 through its wrappers at the
256x256 B=64 and 640x480 B=4 decoder sites of ``chip_smoke.py``, holds
each variant's output bitwise against the plain version, and prints each
variant's time (CUDA events, 20 launches after a warm-up) and its share
of the byte bound.  How those constants were chosen.  Then, at the
source's own constants, builds with a phase of each kernel left out
(``PHASES``: the forward without its output rows, or without its W lerp
and output rows; the backward without its W transpose, or without both
transposes), whose outputs are not the function's and are not checked,
and prints their times beside the whole kernel's: where the time goes.
Exits non-zero without CUDA.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (UP_BAND, BK_BAND, BK_TILE)
SWEEP = [(16, 4, 1024), (16, 8, 512), (8, 4, 512), (8, 8, 256), (32, 16, 256)]
# a phase left out: (kernel, label, the loop heads that become empty loops)
_OUT_ROWS = ("for (int r = r0; r < r1; ++r) {  // y(r", "for (int r = r1; r < r1; ++r) {  // y(r")
_W_LERP = ("for (int j = 0; j < j1 - j0; ++j) {", "for (int j = 0; j < 0; ++j) {")
_H_T = ("for (int R = tid / nf, k = tid % nf; R < nr;) {",
        "for (int R = tid / nf, k = tid % nf; R < 0;) {")
_W_T = ("for (int d = d0 + tid; d < d1; d += UP_THREADS) {",
        "for (int d = d1; d < d1; d += UP_THREADS) {")
PHASES = [("upsample2x", "staging + W lerp", [_OUT_ROWS]),
          ("upsample2x", "staging", [_OUT_ROWS, _W_LERP]),
          ("upsample2x_bwd", "staging + H transpose", [_W_T]),
          ("upsample2x_bwd", "staging", [_W_T, _H_T])]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("upsample2x_sweep: CUDA is not available")
    sys.path[:0] = [REPO, os.path.join(REPO, "tools")]
    import chip_smoke as cs
    from train_elem_ab import variant_library
    from mimo_unet_torch import kernels as K
    from mimo_unet_torch.kernels import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    src = (_build.CSRC_DIR / "upsample2x.cu").read_text()
    libs = {}
    for up_band, bk_band, bk_tile in SWEEP:
        v = re.sub(r"(constexpr int UP_BAND = )\d+;", rf"\g<1>{up_band};", src)
        v = re.sub(r"(constexpr int BK_BAND = )\d+;", rf"\g<1>{bk_band};", v)
        v = re.sub(r"(constexpr int BK_TILE = )[^;]+;", rf"\g<1>{bk_tile};", v)
        libs[up_band, bk_band, bk_tile] = variant_library({"upsample2x.cu": v.encode()})
    cut = {}
    for kern, label, subs in PHASES:
        v = src
        for a, b in subs:
            if v.count(a) != 1:
                raise RuntimeError(f"{label}: loop head {a!r} not found once")
            v = v.replace(a, b)
        cut[kern, label] = variant_library({"upsample2x.cu": v.encode()})
    base = _build.load_library()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    c = cs.F * cs.S
    for b, (h, w) in ((cs.BIG_B, cs.PATCH), (cs.TB, cs.NYU)):
        x = torch.randn((b, h // 2, w // 2, c), device=dev, generator=gen).to(torch.bfloat16)
        g = torch.randn((b, h, w, c), device=dev, generator=gen).to(torch.bfloat16)
        bound = 1.25 * g.numel() * 2 / cs.PEAK_BYTES * 1e3
        for name, fn, plain, arg in (("upsample2x", K.upsample2x, K.upsample2x_plain, x),
                                     ("upsample2x_bwd", K.upsample2x_bwd,
                                      K.upsample2x_bwd_plain, g)):
            want = plain(arg)
            line = []
            for key, lib in libs.items():
                _build._lib = lib
                cs.compare(f"{name} {key}", fn(arg), want, True)
                ms = cs.cuda_ms(lambda: fn(arg), 20)
                line.append(f"{key} {ms:.4f} ms ({bound / ms:.0%})")
            print(f"{name} {h}x{w} B={b} (bound {bound:.4f} ms), ms by "
                  f"(UP_BAND, BK_BAND, BK_TILE): {', '.join(line)} ({card})", flush=True)
            _build._lib = base
            line = [f"whole {cs.cuda_ms(lambda: fn(arg), 20):.4f} ms"]
            for (kern, label), lib in cut.items():
                if kern == name:
                    _build._lib = lib
                    line.append(f"{label} {cs.cuda_ms(lambda: fn(arg), 20):.4f} ms")
            _build._lib = base
            print(f"{name} {h}x{w} B={b} by phase: {', '.join(line)} ({card})", flush=True)
            del want
        del x, g
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
