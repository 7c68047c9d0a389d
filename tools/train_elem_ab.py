#!/usr/bin/env python3
"""K8, K9, K12's backward and K13 against an earlier ``train_elem.cu`` and
``upsample2x.cu``, in turns, on one GPU.

    python3 tools/train_elem_ab.py OLD_TRAIN_ELEM_CU [OLD_UPSAMPLE2X_CU] [--steps]

OLD_TRAIN_ELEM_CU (and OLD_UPSAMPLE2X_CU) are earlier versions of
``mimo_unet_torch/csrc/train_elem.cu`` (and ``upsample2x.cu``) with the
same C entries (for example the parent commit's, unpacked with ``git
archive`` into the git-ignored ``build/``).  The script builds the kernel
library a second time with those files in place of this tree's, into a
directory of its own under the git-ignored ``mimo_unet_torch/_build/``,
and then:

* at the call sites of ``chip_smoke.py`` phases 5, 7 and 10 (640x480 B=4
  and 256x256 B=64) of K9 (``g_eff``), K12's backward
  (``conv1x1_prelu_bwd``, also per image), K8 (``affine_relu`` and its
  backward, also per image) and, given OLD_UPSAMPLE2X_CU, K13
  (``upsample2x`` and its backward), holds each library's output against
  the plain version (bitwise, but the backward sums of K8 and K12 at
  phase 3's tolerance) and against its own second launch, and times the
  old, new, new and old library (CUDA events, 20 launches after a
  warm-up); K12's backward also as its kernel and its ``reduce_groups``
  pass alone; then a device copy of K9's largest input, the rate the
  memory gives a plain stream;
* with ``--steps``, times the flagship train step at 256x256 and the
  NYUv2 step at 640x480, B=16 and B=64, the two libraries in turns (old,
  new, new, old).

The wrappers launch whichever library is loaded; under the old one K8's
backward gets the old kernel's partial rows (one per 256 pixels of a
group, ``train_elem._blocks``).  Every time carries the card's name
and power limit.  Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def variant_library(files):
    """The kernel library with ``files`` ({source name: contents}) in place
    of this tree's sources of those names, built once."""
    from mimo_unet_torch.kernels import _build

    h = hashlib.sha256(_build._digest().encode())
    for name in sorted(files):
        h.update(name.encode())
        h.update(files[name])
    out = _build.BUILD_DIR / "ab" / h.hexdigest()[:16]
    lib = out / _build.LIB_NAME
    if not lib.exists():
        csrc = out / "csrc"
        shutil.rmtree(csrc, ignore_errors=True)
        shutil.copytree(_build.CSRC_DIR, csrc)
        for name, src in files.items():
            (csrc / name).write_bytes(src)
        _build._build(lib, csrc)
    return _build.bind(lib)


def sites(dev, gen, resample=True):
    """(label, kind, tensors) of the K9, K12-backward and K8 call sites,
    and with ``resample`` K13's."""
    import torch

    import chip_smoke as cs

    bf = torch.bfloat16

    def act(*shape, scale=1.0):
        return (torch.randn(shape, device=dev, generator=gen) * scale).to(bf)

    out = []
    mid = (cs.F + cs.F * cs.S) // 2
    for tag, n, hh, ww in (("640x480 B=4", cs.S * cs.TB, cs.TH, cs.TW),
                           ("256x256 B=64", cs.S * cs.BIG_B, cs.HW, cs.HW)):
        for label, div, o in (("in.c1", 1, cs.F), ("in.c2", 1, cs.F),
                              ("down1.c1", 2, 2 * cs.F), ("down1.c2", 2, 2 * cs.F),
                              ("dec.c1", 1, mid), ("dec.c2", 1, cs.F)):
            shape = (n, hh // div, ww // div, o)
            out.append((f"g_eff {tag} {label} ({o} ch)", "g_eff",
                        (act(*shape, scale=0.01), act(*shape, scale=3.0),
                         torch.randn((cs.S, o), device=dev, generator=gen) * 1e-4,
                         torch.randn((cs.S, o), device=dev, generator=gen) * 1e-6)))
        for groups in (cs.S, n):
            out.append((f"conv1x1_prelu_bwd {tag} groups={groups}", "prelu_bwd",
                        (act(n, hh, ww, 2, scale=0.01), act(n, hh, ww, cs.F, scale=3.0),
                         torch.rand((groups, cs.F), device=dev, generator=gen) + 0.5,
                         torch.randn((groups, cs.F), device=dev, generator=gen) * 0.1,
                         (torch.rand((groups, cs.F, 2), device=dev, generator=gen) * 2 - 1)
                         / cs.F ** 0.5)))
        for label, div, c, groups in (("in.x1s", 1, cs.F, cs.S), ("down1", 2, 2 * cs.F, cs.S),
                                      ("in.x1s", 1, cs.F, n)):
            y = act(n, hh // div, ww // div, c, scale=3.0)
            aff = (torch.rand((groups, c), device=dev, generator=gen) + 0.5,
                   torch.randn((groups, c), device=dev, generator=gen) * 0.1)
            tag_k8 = f"{tag} {label} ({c} ch, groups={groups})"
            out.append((f"affine_relu {tag_k8}", "affine_relu", (y, *aff)))
            out.append((f"affine_relu_bwd {tag_k8}", "affine_relu_bwd",
                        (act(*y.shape, scale=0.01), y, *aff)))
        if resample:
            b, c_up = n // cs.S, cs.F * cs.S
            out.append((f"upsample2x {tag} ({c_up} ch)", "upsample2x",
                        (act(b, hh // 2, ww // 2, c_up),)))
            out.append((f"upsample2x_bwd {tag} ({c_up} ch)", "upsample2x_bwd",
                        (act(b, hh, ww, c_up),)))
    return out


def kernels():
    """{kind: (wrapper, plain version, exact)} of the sites' kernels."""
    from mimo_unet_torch import kernels as K

    return {"g_eff": (K.g_eff, K.g_eff_plain, True),
            "prelu_bwd": (K.conv1x1_prelu_bwd, K.conv1x1_prelu_bwd_plain, False),
            "affine_relu": (K.affine_relu, K.affine_relu_plain, True),
            "affine_relu_bwd": (K.affine_relu_bwd, K.affine_relu_bwd_plain, (True, False, False)),
            "upsample2x": (K.upsample2x, K.upsample2x_plain, True),
            "upsample2x_bwd": (K.upsample2x_bwd, K.upsample2x_bwd_plain, True)}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("old", help="an earlier mimo_unet_torch/csrc/train_elem.cu")
    ap.add_argument("old_upsample", nargs="?",
                    help="an earlier mimo_unet_torch/csrc/upsample2x.cu")
    ap.add_argument("--steps", action="store_true", help="also time train steps")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("train_elem_ab: CUDA is not available")
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from mimo_unet_torch.kernels import _build
    from mimo_unet_torch.kernels import train_elem as TE

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    new = _build.load_library()
    for stem in ("train_elem", "upsample2x"):
        for line in _build.build_log.get(stem, "").splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"ptxas {stem} (new)", line.split(":", 1)[-1].strip())
    files = {}
    for name, path in (("train_elem.cu", args.old), ("upsample2x.cu", args.old_upsample)):
        if path:
            with open(path, "rb") as f:
                files[name] = f.read()
    libs = {"new": new, "old": variant_library(files)}
    rows = {"new": TE.affine_relu_bwd_blocks,
            "old": lambda n, hw, c, groups: TE._blocks(n, hw, groups)}

    def use(which):
        _build._lib = libs[which]
        TE.affine_relu_bwd_blocks = rows[which]

    dev = torch.device("cuda", 0)
    order = ("old", "new", "new", "old")
    calls = kernels()
    for label, kind, ts in sites(dev, torch.Generator(device=dev).manual_seed(12),
                                 resample=bool(args.old_upsample)):
        call, plain_fn, exact = calls[kind]
        plain = plain_fn(*ts)
        outs = {}
        for which in ("new", "old"):
            use(which)
            outs[which] = call(*ts)
            torch.cuda.synchronize()
            cs.compare(f"{label} [{which}]", outs[which], plain, exact)
            cs.compare(f"{label} [{which}] launch to launch", call(*ts), outs[which], True)
        del plain, outs
        times = {"old": [], "new": []}
        split = {}
        for which in order:
            use(which)
            times[which].append(cs.cuda_ms(lambda: call(*ts), 20))
            if kind == "prelu_bwd" and which not in split:
                parts = cs.prelu_bwd_parts(*ts)
                n, h, w, c = ts[1].shape
                nrows = TE.prelu_bwd_blocks(n, h * w, c, ts[4].shape[2], ts[4].shape[0])
                split[which] = (cs.cuda_ms(parts["kernel"], 20),
                                cs.cuda_ms(parts["reduce_groups"], 20), nrows)
        line = (f"{label}: old {times['old'][0]:.4f} {times['old'][1]:.4f} ms, "
                f"new {times['new'][0]:.4f} {times['new'][1]:.4f} ms")
        for which, (k, r, nrows) in split.items():
            line += f"; {which} kernel {k:.4f} + reduce_groups {r:.4f} ms ({nrows} rows)"
        print(f"{line} ({card})", flush=True)
        torch.cuda.empty_cache()
    use("new")
    src = torch.empty(cs.S * cs.BIG_B * cs.HW * cs.HW * cs.F, dtype=torch.bfloat16, device=dev)
    dst = torch.empty_like(src)
    t = cs.cuda_ms(lambda: dst.copy_(src), 20)
    print(f"device copy of {src.numel() * 2 / 1e6:.1f} MB (K9's in.c1 y at 256x256 B=64): "
          f"{t:.4f} ms, {4 * src.numel() / t / 1e9:.3f} TB/s read + written ({card})", flush=True)
    del src, dst
    if not args.steps:
        return 0
    task = cs._train_task()
    for hw, b, steps in ((cs.PATCH, cs.TRAIN_B, 5), (cs.PATCH, cs.BIG_B, 3),
                         (cs.NYU, cs.TRAIN_B, 5), (cs.NYU, cs.BIG_B, 3)):
        state = task.init_state(-(-795 // b), dev)
        gen = torch.Generator().manual_seed(13)
        for which in order:
            use(which)
            cs._time_steps(task, state, gen, b, steps, card, f"kernels, {which} sources", hw)
        del state
        torch.cuda.empty_cache()
    use("new")
    return 0


if __name__ == "__main__":
    sys.exit(main())
