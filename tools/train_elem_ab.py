#!/usr/bin/env python3
"""K8, K9, K12 (both ways), K11 (both ways), K13, K4 and K4b against an
earlier ``train_elem.cu``, ``upsample2x.cu`` and ``upsample_w2x.cu``, in
turns, on one GPU.

    python3 tools/train_elem_ab.py OLD_TRAIN_ELEM_CU [OLD_UPSAMPLE2X_CU
                                   [OLD_UPSAMPLE_W2X_CU]] [--steps [STEP ...]]
                                   [--pairs N]

OLD_TRAIN_ELEM_CU (and OLD_UPSAMPLE2X_CU, OLD_UPSAMPLE_W2X_CU) are earlier
versions of ``mimo_unet_torch/csrc/train_elem.cu`` (and ``upsample2x.cu``,
``upsample_w2x.cu``) with the same C entries (for example the parent
commit's, unpacked with ``git archive`` into the git-ignored ``build/``).
The script builds the kernel library a second time with those files, and
the headers (``*.cuh``) beside OLD_TRAIN_ELEM_CU, in place of this tree's,
under the git-ignored ``mimo_unet_torch/_build/`` (``variant_libraries``),
and then:

* at the call sites of ``chip_smoke.py`` phases 3, 5, 7, 10 and 13
  (640x480 B=4, 256x256 B=64, the B=32 serving forward) of K9
  (``g_eff``), K12 (``conv1x1_prelu`` and its backward, also per image),
  K11 (``conv1x1``: the MC-serving decoder, the final-dropout decoder;
  ``conv1x1_bwd``: the final-dropout decoder), K8 (``affine_relu`` and its
  backward, also per image), given OLD_UPSAMPLE2X_CU K13 (``upsample2x``
  and its backward), and given OLD_UPSAMPLE_W2X_CU K4 (``upsample_w2x``:
  up3, the decoder, the x2-half decoder) and K4b (``upsample_w2x_bwd``:
  the x2-half decoder's up4 at 256x256 B=64 and 640x480 B=4), holds each
  library's output against the plain version (bitwise, but the 1x1
  kernels' outputs and the backward sums of K8 and K12 at phase 3's
  tolerance, K11's dz too) and against its own second launch, holds the
  new K12 forward, K11 (its dz), K4 and K4b bitwise against the old, and
  times the old, new, new and old library (``chip_smoke.device_ms``: 20
  calls queued behind a device-side wait); K12's and K11's backward also
  as their kernel and their ``reduce_groups`` pass alone; then a device
  copy of K9's largest input, the rate the memory gives a plain stream;
* with ``--steps``, times the flagship B=32 serving forward (``serve``:
  the device time of one profiled ``Ensemble.raw_forward``, as phase 4
  profiles it, and the median of 15 ``predict`` calls on the host clock)
  and the train steps of ``STEP_CELLS`` (the flagship step at 256x256 and
  the NYUv2 step at 640x480, B=16 and B=64; the final-dropout step at
  640x480 B=4; the x2-half step at 256x256 B=64; the median of a few
  steps on the host clock and the device time of one profiled step), all
  of them or those named, in N pairs of turns (old, new, then new, old,
  and so on; N = 2 by default), every turn printed; then each of them
  (``predict`` and the steps) as 50 pairs of single calls in the same
  pattern, the library switched call by call, so that the host's drift
  from turn to turn falls out of each pair; then for each series the
  pairs where the new library was faster and the median and mean (with
  its 95 % half-width) of the pairs' differences.

The wrappers launch whichever library is loaded; under an old one whose
K8 backward predates its staged tiles, K8's backward gets that kernel's
partial rows (one per 256 pixels of a group, ``old_rows``), and so does
K11's backward under an old one with its 32 x 8 lane kernel.  Every time
carries the card's name and power limit.  Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# redesigned to give the bits of the kernels they replaced: which outputs
SAME_AS_OLD = {"prelu": True, "conv1x1": True, "upsample_w2x": True,
               "conv1x1_bwd": (True, False, False), "upsample_w2x_bwd": True}
# --steps: name -> (frame size, batch, steps a turn, task options, x2-half)
STEP_CELLS = {"patch16": ((256, 256), 16, 5, {}, False),
              "patch64": ((256, 256), 64, 3, {}, False),
              "nyu16": ((480, 640), 16, 5, {}, False),
              "nyu64": ((480, 640), 64, 3, {}, False),
              "final-dropout": ((480, 640), 4, 5, {"final_dropout_rate": 0.1}, False),
              "x2-half": ((256, 256), 64, 3, {}, True)}
PREDICTS = 15  # predict calls a turn of the serving A/B
CALL_PAIRS = 50  # then pairs of single predict calls or steps, the library switched each time


def alternating(pairs):
    """Turns of ``pairs`` old/new pairs: old, new, then new, old, and so on."""
    return sum((("old", "new") if i % 2 == 0 else ("new", "old") for i in range(pairs)), ())


def variant_libraries(variants):
    """{key: {file name: contents}} -> {key: kernel library}: the library
    with each map's files in place of this tree's sources (``*.cu``) and
    headers (``*.cuh``) of those names.  Each object is compiled once for
    its source and headers, under the git-ignored ``mimo_unet_torch/_build/``
    (a source no variant changed, once for all of them), every compile
    started together, then one link a variant.  ``variant_logs[key]``: what
    nvcc printed, by source stem, for the objects compiled in this process."""
    from mimo_unet_torch.kernels import _build

    tree = {p.name: p.read_bytes() for p in _build._sources()}
    nvcc, root = _build._nvcc(), _build.BUILD_DIR / "variants"
    jobs, objs = {}, {}
    for key, files in variants.items():
        texts = {**tree, **files}
        hdr = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
        for name in sorted(n for n in texts if n.endswith(".cuh")):
            hdr.update(name.encode())
            hdr.update(texts[name])
        objs[key] = []
        for name in sorted(n for n in texts if n.endswith(".cu")):
            h = hdr.copy()
            h.update(name.encode())
            h.update(texts[name])
            d = root / h.hexdigest()[:16]
            obj = d / (name[:-3] + ".o")
            if not obj.exists() and d not in jobs:
                d.mkdir(parents=True, exist_ok=True)
                for n, t in texts.items():
                    if n == name or n.endswith(".cuh"):
                        (d / n).write_bytes(t)
                jobs[d] = [nvcc] + _build.NVCC_FLAGS + ["-c", str(d / name), "-o", str(obj)]
            objs[key].append(obj)
    logs = dict(zip(jobs, _build._run_all(list(jobs.values()))))
    links, libs = [], {}
    for key, os_ in objs.items():
        lib = root / hashlib.sha256(" ".join(map(str, os_)).encode()).hexdigest()[:16] / \
            _build.LIB_NAME
        if not lib.exists() and all(lib != l for l, _ in links):
            lib.parent.mkdir(parents=True, exist_ok=True)
            links.append((lib, [nvcc, "-shared", "-o", f"{lib}.tmp"] + list(map(str, os_))))
        libs[key] = lib
        variant_logs[key] = {o.stem: logs[o.parent] for o in os_ if o.parent in logs}
    _build._run_all([cmd for _, cmd in links])
    for lib, _ in links:  # renamed once whole: a killed link leaves no library
        os.replace(f"{lib}.tmp", lib)
    return {key: _build.bind(lib) for key, lib in libs.items()}


variant_logs = {}


def old_rows(n, hw, groups):
    """Partial rows of the 256-pixel-block backward kernels (K8's before its
    staged tiles, K11's 32 x 8 lane kernel): one per 256 pixels of a
    group."""
    return groups * -(-(n // groups * hw) // 256)


def sites(dev, gen, resample=True, w2x=False):
    """(label, kind, tensors) of the K9, K12, K11 and K8 call sites, with
    ``resample`` K13's, and with ``w2x`` K4's and K4b's."""
    import torch

    import chip_smoke as cs

    bf = torch.bfloat16

    def act(*shape, scale=1.0):
        return (torch.randn(shape, device=dev, generator=gen) * scale).to(bf)

    def out_conv(groups):
        return ((torch.rand((groups, cs.F, 2), device=dev, generator=gen) * 2 - 1) / cs.F ** 0.5,
                torch.randn((groups, 2), device=dev, generator=gen) * 0.1)

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
            wo = (torch.rand((groups, cs.F, 2), device=dev, generator=gen) * 2 - 1) / cs.F ** 0.5
            out.append((f"conv1x1_prelu {tag} groups={groups}", "prelu",
                        (act(n, hh, ww, cs.F, scale=3.0),
                         torch.rand((groups, cs.F), device=dev, generator=gen) + 0.5,
                         torch.randn((groups, cs.F), device=dev, generator=gen) * 0.1,
                         wo, torch.randn((groups, 2), device=dev, generator=gen) * 0.1)))
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
        if tag == "640x480 B=4":  # K11 both ways: the final-dropout decoder
            z = act(n, hh, ww, cs.F)
            wo, bo = out_conv(cs.S)
            out.append((f"conv1x1 {tag} final-dropout decoder", "conv1x1", (z, wo, bo)))
            out.append((f"conv1x1_bwd {tag} final-dropout decoder", "conv1x1_bwd",
                        (act(n, hh, ww, 2, scale=0.01), z, wo)))
        if resample:
            b, c_up = n // cs.S, cs.F * cs.S
            out.append((f"upsample2x {tag} ({c_up} ch)", "upsample2x",
                        (act(b, hh // 2, ww // 2, c_up),)))
            out.append((f"upsample2x_bwd {tag} ({c_up} ch)", "upsample2x_bwd",
                        (act(b, hh, ww, c_up),)))
    n_mc = cs.S * cs.MC_B * cs.MC_STEPS  # K11's forward: the MC-serving decoder
    out.append((f"conv1x1 MC decoder N={n_mc} @256", "conv1x1",
                (act(n_mc, cs.HW, cs.HW, cs.F),) + out_conv(cs.S)))
    if w2x:  # K4: up3 and the decoder of the B=32 serving forward, the x2-half decoder
        fs = cs.F * cs.S
        for label, shape in (("up3", (cs.B, cs.HW // 4, cs.HW // 4, 2 * fs)),
                             ("decoder", (cs.B, cs.HW // 2, cs.HW // 2, fs)),
                             ("x2-half up4 256x256 B=64", (cs.BIG_B, cs.HW // 2, cs.HW // 2, fs))):
            out.append((f"upsample_w2x {label} {list(shape)}", "upsample_w2x", (act(*shape),)))
        fs = cs.F * cs.S  # K4b: the x2-half decoder's up4 W-half cotangent
        for tag, b, (h, w) in (("256x256 B=64", cs.BIG_B, cs.PATCH), ("640x480 B=4", cs.TB, cs.NYU)):
            shape = (b, h // 2, w, fs)
            out.append((f"upsample_w2x_bwd x2-half up4 {tag} {list(shape)}", "upsample_w2x_bwd",
                        (act(*shape),)))
    return out


def kernels():
    """{kind: (wrapper, plain version, exact)} of the sites' kernels."""
    from mimo_unet_torch import kernels as K

    return {"g_eff": (K.g_eff, K.g_eff_plain, True),
            "prelu": (K.conv1x1_prelu, K.conv1x1_prelu_plain, False),
            "conv1x1": (K.conv1x1, K.conv1x1_plain, False),
            "upsample_w2x": (K.upsample_w2x, K.upsample_w2x_plain, True),
            "upsample_w2x_bwd": (K.upsample_w2x_bwd, K.upsample_w2x_bwd_plain, True),
            "conv1x1_bwd": (K.conv1x1_bwd, K.conv1x1_bwd_plain, False),
            "prelu_bwd": (K.conv1x1_prelu_bwd, K.conv1x1_prelu_bwd_plain, False),
            "affine_relu": (K.affine_relu, K.affine_relu_plain, True),
            "affine_relu_bwd": (K.affine_relu_bwd, K.affine_relu_bwd_plain, (True, False, False)),
            "upsample2x": (K.upsample2x, K.upsample2x_plain, True),
            "upsample2x_bwd": (K.upsample2x_bwd, K.upsample2x_bwd_plain, True)}


def serve_ab(use, order, dev, card):
    """The flagship B=32 serving forward under each library in turns: the
    device time of one profiled ``Ensemble.raw_forward`` (the sum of its
    kernels' times) and the median of ``PREDICTS`` ``predict`` calls, by
    turn; then ``CALL_PAIRS`` pairs of single ``predict`` calls, the
    library switched call by call.  Returns {label: (order, ms)}."""
    import torch

    import chip_smoke as cs
    from mimo_unet_torch.models.ensemble import Ensemble

    task, model = cs._flagship(dev)
    ens = Ensemble([(task, model)])
    image = torch.rand((cs.B, cs.HW, cs.HW, 3), device=dev,
                       generator=torch.Generator(dev).manual_seed(8))
    req = torch.rand((cs.B, cs.HW, cs.HW, 3), generator=torch.Generator().manual_seed(2)).numpy()
    out = {"device busy": [], "predict": []}
    for which in order:
        use(which)
        ens.raw_forward(image)
        ens.predict(req, batch_size=cs.B)
        torch.cuda.synchronize()
        busy = cs.busy_ms(lambda: ens.raw_forward(image))
        times = []
        for _ in range(PREDICTS):
            t0 = time.perf_counter()
            ens.predict(req, batch_size=cs.B)
            times.append(time.perf_counter() - t0)
        times.sort()
        print(f"serving B={cs.B} forward, {which} sources: device busy {busy:.3f} ms, "
              f"predict median {times[PREDICTS // 2] * 1e3:.2f} ms (min {times[0] * 1e3:.2f}, "
              f"max {times[-1] * 1e3:.2f}) ({card})",
              flush=True)
        out["device busy"].append(busy)
        out["predict"].append(times[PREDICTS // 2] * 1e3)
    calls = alternating(CALL_PAIRS)
    each = []
    for which in calls:
        use(which)
        t0 = time.perf_counter()
        ens.predict(req, batch_size=cs.B)
        each.append((time.perf_counter() - t0) * 1e3)
    return {f"serving B={cs.B} {k}": (order, v) for k, v in out.items()} | \
        {f"serving B={cs.B} predict, call by call": (calls, each)}


def pair_summary(label, order, times, card):
    """Print the turns of ``times`` (ms, one a turn of ``order``) by library,
    the pairs where the new library was faster, and the median and the mean
    of the pairs' differences, new - old, the mean with its 95 % half-width
    (1.96 standard errors)."""
    by = {w: [t for o, t in zip(order, times) if o == w] for w in ("old", "new")}
    diffs = sorted(n - o for o, n in zip(by["old"], by["new"]))
    n = len(diffs)
    mean = sum(diffs) / n
    half = 1.96 * (sum((d - mean) ** 2 for d in diffs) / (n - 1) / n) ** 0.5 if n > 1 else 0.0
    print(f"{label}: old {', '.join(f'{t:.3f}' for t in by['old'])}; "
          f"new {', '.join(f'{t:.3f}' for t in by['new'])}; new faster in "
          f"{sum(d < 0 for d in diffs)} of {n} pairs, difference (new - old) median "
          f"{diffs[n // 2]:+.3f} ms, mean {mean:+.3f} +- {half:.3f} ms ({card})", flush=True)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("old", help="an earlier mimo_unet_torch/csrc/train_elem.cu")
    ap.add_argument("old_upsample", nargs="?",
                    help="an earlier mimo_unet_torch/csrc/upsample2x.cu")
    ap.add_argument("old_upsample_w2x", nargs="?",
                    help="an earlier mimo_unet_torch/csrc/upsample_w2x.cu")
    ap.add_argument("--steps", nargs="*", choices=["serve", *STEP_CELLS],
                    help="also time the serving forward and train steps (all, or "
                         "those named)")
    ap.add_argument("--pairs", type=int, default=2,
                    help="old/new pairs of turns of each --steps timing")
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
    for stem in ("train_elem", "upsample2x", "upsample_w2x"):
        for line in _build.build_log.get(stem, "").splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"ptxas {stem} (new)", line.split(":", 1)[-1].strip())
    files = {}
    for name, path in (("train_elem.cu", args.old), ("upsample2x.cu", args.old_upsample),
                       ("upsample_w2x.cu", args.old_upsample_w2x)):
        if path:
            with open(path, "rb") as f:
                files[name] = f.read()
    for hdr in glob.glob(os.path.join(os.path.dirname(os.path.abspath(args.old)), "*.cuh")):
        with open(hdr, "rb") as f:  # the headers the old sources were written against
            files[os.path.basename(hdr)] = f.read()
    libs = {"new": new, **variant_libraries({"old": files})}
    old_src = files["train_elem.cu"]
    rows = {"new": (TE.affine_relu_bwd_blocks, TE.conv1x1_bwd_blocks),
            "old": (TE.affine_relu_bwd_blocks if b"affine_bwd_kernel" in old_src
                    else lambda n, hw, c, groups: old_rows(n, hw, groups),
                    lambda n, hw, c, oc, groups: old_rows(n, hw, groups)
                    if b"conv1x1_bwd_kernel" in old_src else TE.conv1x1_bwd_blocks)}

    def use(which):
        _build._lib = libs[which]
        TE.affine_relu_bwd_blocks, TE.conv1x1_bwd_blocks = rows[which]

    dev = torch.device("cuda", 0)
    order = ("old", "new", "new", "old")
    calls = kernels()
    for label, kind, ts in sites(dev, torch.Generator(device=dev).manual_seed(12),
                                 resample=bool(args.old_upsample),
                                 w2x=bool(args.old_upsample_w2x)):
        call, plain_fn, exact = calls[kind]
        plain = plain_fn(*ts)
        outs = {}
        for which in ("new", "old"):
            use(which)
            outs[which] = call(*ts)
            torch.cuda.synchronize()
            cs.compare(f"{label} [{which}]", outs[which], plain, exact)
            cs.compare(f"{label} [{which}] launch to launch", call(*ts), outs[which], True)
        if kind in SAME_AS_OLD:
            cs.compare(f"{label} new vs old", outs["new"], outs["old"], SAME_AS_OLD[kind])
        del plain, outs
        times = {"old": [], "new": []}
        split = {}
        for which in order:
            use(which)
            times[which].append(cs.cuda_ms(lambda: call(*ts), 20))
            if kind in ("prelu_bwd", "conv1x1_bwd") and which not in split:
                wo, (n, h, w, c) = ts[-1], ts[1].shape
                if kind == "prelu_bwd":
                    parts = cs.prelu_bwd_parts(*ts)
                    nrows = TE.prelu_bwd_blocks(n, h * w, c, wo.shape[2], wo.shape[0])
                else:
                    parts = cs.conv1x1_bwd_parts(*ts)
                    nrows = TE.conv1x1_bwd_blocks(n, h * w, c, wo.shape[2], wo.shape[0])
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
    if args.steps is None:
        return 0
    named = args.steps or ["serve", *STEP_CELLS]
    turns = alternating(args.pairs)
    summary = serve_ab(use, turns, dev, card) if "serve" in named else {}
    for name in (n for n in STEP_CELLS if n in named):
        hw, b, steps, options, x2_half = STEP_CELLS[name]
        os.environ[cs.X2_HALF] = "1" if x2_half else "0"
        task = cs._train_task(**options)
        state = task.init_state(-(-795 // b), dev)
        gen = torch.Generator().manual_seed(13)
        tag = f"train step {name} {hw[0]}x{hw[1]} B={b}"
        summary[f"{tag} median"] = (turns, [])
        summary[f"{tag} device busy"] = (turns, [])
        batch, each = cs._frames(gen, b, hw), []
        for which in turns:
            use(which)
            summary[f"{tag} median"][1].append(1e3 * cs._time_steps(
                task, state, gen, b, steps, card, f"{name}, kernels, {which} sources", hw))
            summary[f"{tag} device busy"][1].append(
                cs.busy_ms(lambda: task.train_step(state, batch)))
        for which in alternating(CALL_PAIRS):
            use(which)
            t0 = time.perf_counter()
            task.train_step(state, batch)
            torch.cuda.synchronize()
            each.append((time.perf_counter() - t0) * 1e3)
        summary[f"{tag}, step by step"] = (alternating(CALL_PAIRS), each)
        del state, batch
        torch.cuda.empty_cache()
    os.environ[cs.X2_HALF] = "0"
    for label, (order, times) in summary.items():
        pair_summary(label, order, times, card)
    use("new")
    return 0


if __name__ == "__main__":
    sys.exit(main())
