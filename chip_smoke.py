#!/usr/bin/env python3
"""Drive the PyTorch port's eval/serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository.  Phases, each raising on failure:

1. Require CUDA; print the card (``nvidia-smi --query-gpu=name,power.limit
   --format=csv,noheader``) and the CUDA version.
2. Build the hand-written kernels from ``mimo_unet_torch/csrc`` and print
   the build time.
3. Call every kernel at each of its flagship call sites (S=2, fbc=21,
   256x256, B=32, bf16) on the card and hold it against its plain PyTorch
   version (float32 with TF32 off): pool_w and upsample_w2x bitwise, the
   DoubleConv kernels at max abs <= 1e-2 * max|ref| and mean abs <= 1e-3 *
   max|ref|.  Print the errors and both times (CUDA events).
4. Serve: the flagship MimoUnetTask's model (seeded weights, random
   BatchNorm statistics) in an Ensemble answers three predict calls of 32
   random 256x256x3 images and one of a single image through the kernel
   path; the launch counters must show every kernel ran, the outputs must
   be finite with variances >= 0, and they must match the plain model
   (ct_kernels="off") on the card within 3e-2 * max|ref|.
5. Print the kernels' JSON line, then the result line
   ``{"ok": true, "device": {...}}`` last.

Exits non-zero, printing no result, without CUDA or outside the repo.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
B, S, F, HW = 32, 2, 21, 256
KERNEL_INFO = {
    "fused_double_conv": ("mimo_unet_torch/csrc/fused_double_conv.cu",
                          "mimo_unet_tpu/ops/pallas/ct_conv.py:756"),
    "fused_double_conv9": ("mimo_unet_torch/csrc/fused_double_conv.cu",
                           "mimo_unet_tpu/ops/pallas/ct_conv.py:496"),
    "pool_w": ("mimo_unet_torch/csrc/pool_w.cu",
               "mimo_unet_tpu/ops/pallas/ct_elem.py:193"),
    "upsample_w2x": ("mimo_unet_torch/csrc/upsample_w2x.cu",
                     "mimo_unet_tpu/ops/pallas/ct_resize.py:209"),
}


def cuda_ms(fn, iters):
    """Mean device time of ``fn()`` over ``iters`` runs after one warm-up."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(name, got, want, exact):
    """Max abs error of ``got`` vs ``want`` (tuples compared pairwise);
    raises past the tolerance."""
    import torch

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    worst = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: {tuple(g.shape)} {g.dtype} vs "
                                 f"{tuple(w.shape)} {w.dtype}")
        err = (g.float() - w.float()).abs()
        worst = max(worst, float(err.max()))
        if exact:
            if not torch.equal(g, w):
                raise AssertionError(f"{name}: not bitwise equal "
                                     f"(max abs {float(err.max())})")
            continue
        scale = float(w.float().abs().max()) or 1.0
        if float(err.max()) > 1e-2 * scale or float(err.mean()) > 1e-3 * scale:
            raise AssertionError(f"{name}: max abs {float(err.max())}, mean abs "
                                 f"{float(err.mean())}, scale {scale}")
    return worst


def kernel_sites(dev, gen):
    """(kernel name, site, kernel call, plain call, exact) at the flagship
    call-site shapes of mimo_unet_torch/models/fast_path.py."""
    import torch
    from mimo_unet_torch import kernels as K

    bf = torch.bfloat16
    fs = F * S

    def act(*shape):
        return torch.randn(shape, device=dev, generator=gen).to(bf)

    def dc(g, cin, m, o):
        w1 = (torch.rand((g, 3, 3, cin, m), device=dev, generator=gen) * 2 - 1) / (9 * cin) ** 0.5
        w2 = (torch.rand((g, 3, 3, m, o), device=dev, generator=gen) * 2 - 1) / (9 * m) ** 0.5
        s1 = torch.rand((g, m), device=dev, generator=gen) + 0.5
        s2 = torch.rand((g, o), device=dev, generator=gen) + 0.5
        sh1 = torch.randn((g, m), device=dev, generator=gen) * 0.1
        sh2 = torch.randn((g, o), device=dev, generator=gen) * 0.1
        return w1, s1, sh1, w2, s2, sh2

    n = S * B
    sites = []
    x = act(n, HW, HW, 3)
    a = dc(S, 3, F, F)
    sites.append(("fused_double_conv9", "in_conv 3->21->21 @256 +hpool",
                  lambda: K.fused_double_conv9(x, *a, emit_hpool=True),
                  lambda: K.fused_double_conv9_plain(x, *a, emit_hpool=True),
                  False))
    hp1 = act(n, HW // 2, HW, F)
    sites.append(("pool_w", "down1 pool [64,128,256,21]",
                  lambda: K.pool_w(hp1), lambda: K.pool_w_plain(hp1), True))
    p1 = act(n, HW // 2, HW // 2, F)
    d = dc(S, F, 2 * F, 2 * F)
    sites.append(("fused_double_conv",
                  "down1 21->42->42 @128 +hpool +group_rows_out",
                  lambda: K.fused_double_conv(p1, *d, emit_hpool=True,
                                              group_rows_out=True),
                  lambda: K.fused_double_conv_plain(p1, *d, emit_hpool=True,
                                                    group_rows_out=True),
                  False))
    hp2 = act(B, HW // 4, HW // 2, 2 * fs)
    sites.append(("pool_w", "core pool [32,64,128,84]",
                  lambda: K.pool_w(hp2), lambda: K.pool_w_plain(hp2), True))
    xu2 = act(B, HW // 4, HW // 4, 2 * fs)
    sites.append(("upsample_w2x", "up3 W-half [32,64,64,84]",
                  lambda: K.upsample_w2x(xu2),
                  lambda: K.upsample_w2x_plain(xu2), True))
    x2cat, xu2w = act(B, HW // 2, HW // 2, 2 * fs), act(B, HW // 4, HW // 2, 2 * fs)
    u = dc(1, 4 * fs, 2 * fs, fs)
    sites.append(("fused_double_conv", "up3 (84+84)->84->42 @128 +x2_half_h",
                  lambda: K.fused_double_conv(x2cat, *u, x2=xu2w, x2_half_h=True),
                  lambda: K.fused_double_conv_plain(x2cat, *u, x2=xu2w,
                                                    x2_half_h=True),
                  False))
    xup = act(B, HW // 2, HW // 2, fs)
    sites.append(("upsample_w2x", "decoder W-half [32,128,128,42]",
                  lambda: K.upsample_w2x(xup),
                  lambda: K.upsample_w2x_plain(xup), True))
    x1s, xupw = act(n, HW, HW, F), act(B, HW // 2, HW, fs)
    e = dc(S, F + fs, (F + fs) // 2, F)
    wo = (torch.rand((S, F, 2), device=dev, generator=gen) * 2 - 1) / F ** 0.5
    bo = torch.randn((S, 2), device=dev, generator=gen) * 0.1
    sites.append(("fused_double_conv",
                  "decoder (21+42)->31->21->2 @256 +x2_half_h +out-conv",
                  lambda: K.fused_double_conv(x1s, *e, x2=xupw, x2_half_h=True,
                                              wo=wo, bo=bo),
                  lambda: K.fused_double_conv_plain(x1s, *e, x2=xupw,
                                                    x2_half_h=True, wo=wo,
                                                    bo=bo),
                  False))
    return sites


def check_kernels(dev, card):
    """Phase 3: every kernel against its plain version at the flagship
    call sites; returns per-kernel {max_abs_err, ms, plain_ms}, the times
    summed over the call sites of one forward."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(0)
    stats = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
             for k in KERNEL_INFO}
    for name, site, kern, plain, exact in kernel_sites(dev, gen):
        got = kern()
        torch.cuda.synchronize()
        err = compare(f"{name} [{site}]", got, plain(), exact)
        del got
        iters = 20 if exact else 5
        ms, plain_ms = cuda_ms(kern, iters), cuda_ms(plain, iters)
        st = stats[name]
        st["max_abs_err"] = max(st["max_abs_err"], err)
        st["ms"] += ms
        st["plain_ms"] += plain_ms
        print(f"kernel {name} [{site}]: max_abs_err {err} "
              f"({'bitwise' if exact else 'tolerance'}), {ms:.4f} ms vs plain "
              f"{plain_ms:.4f} ms ({card})")
    return stats


def serve(dev, card, ct_kernels="auto"):
    """Phase 4: the flagship served through an Ensemble; returns the
    kernels' launch counts over the requests."""
    import torch
    from mimo_unet_torch import kernels as K
    from mimo_unet_torch.models.ensemble import Ensemble
    from mimo_unet_torch.tasks.mimo import MimoUnetTask

    task = MimoUnetTask(in_channels=3, out_channels=2, num_subnetworks=S,
                        filter_base_count=F, loss="laplace_nll",
                        compute_dtype="bfloat16", ct_kernels=ct_kernels)
    cpu_gen = torch.Generator().manual_seed(1)
    model = task.build_model(dev, cpu_gen)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                c = mod.num_features
                mod.weight.copy_(torch.rand(c, generator=cpu_gen) + 0.5)
                mod.bias.copy_(torch.randn(c, generator=cpu_gen) * 0.1)
                mod.running_mean.copy_(torch.randn(c, generator=cpu_gen) * 0.1)
                mod.running_var.copy_(torch.rand(c, generator=cpu_gen) + 0.5)
    ens = Ensemble([(task, model)])
    rng = torch.Generator().manual_seed(2)
    requests = [torch.rand((B, HW, HW, 3), generator=rng).numpy()
                for _ in range(3)]
    requests.append(torch.rand((1, HW, HW, 3), generator=rng).numpy())

    for req in (requests[0], requests[-1]):  # warm-up: cuDNN plans per shape
        ens.predict(req, batch_size=req.shape[0])
    torch.cuda.synchronize()
    K.reset_launch_counts()
    answers = []
    for req in requests:
        t0 = time.perf_counter()
        answers.append(ens.predict(req, batch_size=req.shape[0]))
        dt = time.perf_counter() - t0
        print(f"predict B={req.shape[0]}: {dt * 1e3:.3f} ms, "
              f"{req.shape[0] / dt:.1f} patches/s ({card})")
    launches = K.launch_counts()
    print(f"launches: {launches}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the serving path: {missing}")

    off_task = dataclasses.replace(task, ct_kernels="off")
    off_model = off_task.build_model(dev)
    off_model.load_state_dict(model.state_dict())
    off = Ensemble([(off_task, off_model)])
    for req, (mean, ale, epi) in zip(requests, answers):
        for name, arr in (("mean", mean), ("aleatoric", ale), ("epistemic", epi)):
            if arr.shape != (req.shape[0], HW, HW, 1):
                raise AssertionError(f"{name}: shape {arr.shape}")
            if not torch.isfinite(torch.from_numpy(arr)).all():
                raise AssertionError(f"{name}: non-finite values")
        if (ale < 0).any() or (epi < 0).any():
            raise AssertionError("negative variance")
        ref_mean, ref_ale, ref_epi = off.predict(req, batch_size=req.shape[0])
        # the epistemic variance of near-equal subnetwork predictions is the
        # square of a small difference: it is held as a standard deviation,
        # at the predictions' scale
        pred_scale = float(abs(ref_mean).max()) or 1.0
        for name, got, want, scale in (
                ("mean", mean, ref_mean, pred_scale),
                ("aleatoric var", ale, ref_ale, float(abs(ref_ale).max()) or 1.0),
                ("epistemic std", epi ** 0.5, ref_epi ** 0.5, pred_scale)):
            err = float(abs(got - want).max())
            print(f"serve B={req.shape[0]} {name}: max abs vs ct_kernels=off "
                  f"{err} (scale {scale})")
            if err > 3e-2 * scale:
                raise AssertionError(f"{name}: kernel path vs plain {err} > "
                                     f"3e-2 * {scale}")
    return launches


def main() -> int:
    import torch

    # ---- 1. the card ------------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: CUDA is not available")
    sys.path.insert(0, REPO)
    from mimo_unet_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_library()
    built = _build.build_seconds
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({'nvcc ' + format(built, '.2f') + ' s' if built else 'cached'})")

    # ---- 3, 4 ----------------------------------------------------------------
    stats = check_kernels(dev, card)
    torch.cuda.empty_cache()
    launches = serve(dev, card)

    # ---- 5. results --------------------------------------------------------
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": KERNEL_INFO[k][0],
         "replaces": KERNEL_INFO[k][1], "launches": launches[k], **stats[k]}
        for k in KERNEL_INFO]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
