#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository.  Phases, each raising on failure:

1. Require CUDA; print the card (``nvidia-smi --query-gpu=name,power.limit
   --format=csv,noheader``) and the CUDA version.
2. Build the hand-written kernels from ``mimo_unet_torch/csrc`` (one nvcc
   per source, in parallel) and print the build time.
3. Eval kernels: call each at its flagship serving call sites (S=2, fbc=21,
   256x256, B=32, bf16) and hold it against its plain PyTorch version
   (float32, TF32 off): pool_w and upsample_w2x bitwise, the DoubleConv
   kernels at max abs <= 1e-2 * max|ref| and mean abs <= 1e-3 * max|ref|.
4. Serve: the flagship MimoUnetTask's model (seeded weights, random
   BatchNorm statistics) in an Ensemble answers three predict calls of 32
   random 256x256x3 images and one of a single image through the kernel
   path; the eval kernels' launch counters must show each ran, the
   outputs must be finite with variances >= 0, and they must match the
   plain model (ct_kernels="off") within 3e-2 * max|ref|.
5. Train kernels: every train kernel at its 640x480 call sites (NYUv2
   frames, S=2, fbc=21, B=4), each output and gradient against its plain
   version at the same tolerance as phase 3.
6. Train: the NYUv2-depth task (S=2, fbc=21, bf16, Laplace NLL, lr 1e-3,
   loss buffer 10) at 640x480: ``init_state`` on the card, one step's loss
   and gradients against the plain model (ct_kernels="off", same weights:
   loss within 2e-2 relative, gradient cosine >= 0.99 per leaf above the
   noise threshold of tests/test_ct_train.py:228), then 3 ``train_step``s
   of B=16 seeded random uint8 frames whose launch counters must show
   every train kernel ran and whose loss and parameters stay finite; then
   a profile of one B=16 step (device time by phase and the top device
   operations) and step times at B=16 and B=64.
7. Print the kernels' JSON line, then the result line
   ``{"ok": true, "device": {...}}`` last.

Every time carries the card's name and power limit.  Exits non-zero,
printing no result, without CUDA or outside the repo.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
B, S, F, HW = 32, 2, 21, 256           # eval flagship
TB, TH, TW = 4, 480, 640               # train kernel call sites (NYUv2)
TRAIN_B, BIG_B = 16, 64                # train steps; the documented batch
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12  # H100 SXM bf16 dense, HBM3
_E = "mimo_unet_tpu/ops/pallas/"
KERNEL_INFO = {
    "fused_double_conv": ("mimo_unet_torch/csrc/fused_double_conv.cu", _E + "ct_conv.py:756"),
    "fused_double_conv9": ("mimo_unet_torch/csrc/fused_double_conv.cu", _E + "ct_conv.py:496"),
    "pool_w": ("mimo_unet_torch/csrc/pool_w.cu", _E + "ct_elem.py:193"),
    "upsample_w2x": ("mimo_unet_torch/csrc/upsample_w2x.cu", _E + "ct_resize.py:222"),
    "conv3x3_fwd": ("mimo_unet_torch/csrc/conv3x3_train.cu", _E + "ct_train.py:283"),
    "conv3x3_dx": ("mimo_unet_torch/csrc/conv3x3_train.cu", _E + "ct_train.py:579"),
    "conv3x3_dx_fold": ("mimo_unet_torch/csrc/conv3x3_train.cu", _E + "ct_train.py:677"),
    "conv3x3_dw": ("mimo_unet_torch/csrc/conv3x3_train.cu", _E + "ct_train.py:815"),
    "g_eff": ("mimo_unet_torch/csrc/train_elem.cu", _E + "ct_elem.py:140"),
    "affine_relu": ("mimo_unet_torch/csrc/train_elem.cu", _E + "ct_elem.py:83"),
    "affine_relu_bwd": ("mimo_unet_torch/csrc/train_elem.cu", _E + "ct_elem.py:106"),
    "conv1x1_prelu": ("mimo_unet_torch/csrc/train_elem.cu", _E + "ct_elem.py:527"),
    "conv1x1_prelu_bwd": ("mimo_unet_torch/csrc/train_elem.cu", _E + "ct_elem.py:560"),
}


@dataclasses.dataclass
class Site:
    """One kernel call site: the kernel call, its plain version, whether
    they must agree bitwise, the work (operations, bytes) the call must do,
    and the nearest single PyTorch call, if any."""
    name: str
    site: str
    kern: object
    plain: object
    exact: bool
    flops: float
    nbytes: float
    library: object = None


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
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} outputs vs {len(want)}")
    worst = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: {tuple(g.shape)} {g.dtype} vs "
                                 f"{tuple(w.shape)} {w.dtype}")
        err = (g.float() - w.float()).abs()
        if not bool(torch.isfinite(g.float()).all()):
            raise AssertionError(f"{name}: non-finite output")
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


def _nbytes(*shapes_and_sizes):
    """Sum of prod(shape) * element size over (shape, element size) pairs."""
    total = 0
    for shape, size in shapes_and_sizes:
        n = 1
        for d in shape:
            n *= d
        total += n * size
    return float(total)


def eval_sites(dev, gen):
    """The eval kernels at the flagship call-site shapes of
    mimo_unet_torch/models/fast_path.py ``mimo_unet_apply_fast``."""
    import torch
    import torch.nn.functional as Fn
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

    def dc_work(px, cin, m, o, g, ins, outs, oc=0):
        flops = 2.0 * px * (9 * cin * m + 9 * m * o + o * oc)
        wbytes = g * 9 * (cin * m + m * o) * 2 + g * o * oc * 2
        return flops, _nbytes(*[(s, 2) for s in ins + outs]) + wbytes

    def nchw(t):
        return t.permute(0, 3, 1, 2)

    n = S * B
    sites = []
    x = act(n, HW, HW, 3)
    a = dc(S, 3, F, F)
    sites.append(Site("fused_double_conv9", "in_conv 3->21->21 @256 +hpool",
                      lambda: K.fused_double_conv9(x, *a, emit_hpool=True),
                      lambda: K.fused_double_conv9_plain(x, *a, emit_hpool=True),
                      False, *dc_work(n * HW * HW, 3, F, F, S, [x.shape],
                                      [(n, HW, HW, F), (n, HW // 2, HW, F)])))
    hp1 = act(n, HW // 2, HW, F)
    sites.append(Site("pool_w", "down1 pool [64,128,256,21]",
                      lambda: K.pool_w(hp1), lambda: K.pool_w_plain(hp1), True,
                      hp1.numel() / 2, _nbytes((hp1.shape, 2)) * 1.5,
                      lambda: Fn.max_pool2d(nchw(hp1), (1, 2))))
    p1 = act(n, HW // 2, HW // 2, F)
    d = dc(S, F, 2 * F, 2 * F)
    sites.append(Site("fused_double_conv",
                      "down1 21->42->42 @128 +hpool +group_rows_out",
                      lambda: K.fused_double_conv(p1, *d, emit_hpool=True,
                                                  group_rows_out=True),
                      lambda: K.fused_double_conv_plain(p1, *d, emit_hpool=True,
                                                        group_rows_out=True),
                      False, *dc_work(n * (HW // 2) ** 2, F, 2 * F, 2 * F, S,
                                      [p1.shape], [(B, HW // 2, HW // 2, 2 * fs),
                                                   (B, HW // 4, HW // 2, 2 * fs)])))
    hp2 = act(B, HW // 4, HW // 2, 2 * fs)
    sites.append(Site("pool_w", "core pool [32,64,128,84]",
                      lambda: K.pool_w(hp2), lambda: K.pool_w_plain(hp2), True,
                      hp2.numel() / 2, _nbytes((hp2.shape, 2)) * 1.5,
                      lambda: Fn.max_pool2d(nchw(hp2), (1, 2))))
    xu2 = act(B, HW // 4, HW // 4, 2 * fs)
    sites.append(Site("upsample_w2x", "up3 W-half [32,64,64,84]",
                      lambda: K.upsample_w2x(xu2),
                      lambda: K.upsample_w2x_plain(xu2), True,
                      3.0 * xu2.numel() * 2, _nbytes((xu2.shape, 2)) * 3,
                      lambda: Fn.interpolate(nchw(xu2), size=(HW // 4, HW // 2),
                                             mode="bilinear", align_corners=True)))
    x2cat, xu2w = act(B, HW // 2, HW // 2, 2 * fs), act(B, HW // 4, HW // 2, 2 * fs)
    u = dc(1, 4 * fs, 2 * fs, fs)
    sites.append(Site("fused_double_conv", "up3 (84+84)->84->42 @128 +x2_half_h",
                      lambda: K.fused_double_conv(x2cat, *u, x2=xu2w, x2_half_h=True),
                      lambda: K.fused_double_conv_plain(x2cat, *u, x2=xu2w,
                                                        x2_half_h=True),
                      False, *dc_work(B * (HW // 2) ** 2, 4 * fs, 2 * fs, fs, 1,
                                      [x2cat.shape, xu2w.shape],
                                      [(B, HW // 2, HW // 2, fs)])))
    xup = act(B, HW // 2, HW // 2, fs)
    sites.append(Site("upsample_w2x", "decoder W-half [32,128,128,42]",
                      lambda: K.upsample_w2x(xup),
                      lambda: K.upsample_w2x_plain(xup), True,
                      3.0 * xup.numel() * 2, _nbytes((xup.shape, 2)) * 3,
                      lambda: Fn.interpolate(nchw(xup), size=(HW // 2, HW),
                                             mode="bilinear", align_corners=True)))
    x1s, xupw = act(n, HW, HW, F), act(B, HW // 2, HW, fs)
    e = dc(S, F + fs, (F + fs) // 2, F)
    wo = (torch.rand((S, F, 2), device=dev, generator=gen) * 2 - 1) / F ** 0.5
    bo = torch.randn((S, 2), device=dev, generator=gen) * 0.1
    sites.append(Site("fused_double_conv",
                      "decoder (21+42)->31->21->2 @256 +x2_half_h +out-conv",
                      lambda: K.fused_double_conv(x1s, *e, x2=xupw, x2_half_h=True,
                                                  wo=wo, bo=bo),
                      lambda: K.fused_double_conv_plain(x1s, *e, x2=xupw,
                                                        x2_half_h=True, wo=wo,
                                                        bo=bo),
                      False, *dc_work(n * HW * HW, F + fs, (F + fs) // 2, F, S,
                                      [x1s.shape, xupw.shape], [(n, HW, HW, 2)],
                                      oc=2)))
    return sites


def train_sites(dev, gen):
    """The train kernels at their call sites of
    mimo_unet_torch/models/fast_path.py ``mimo_unet_apply_train`` at
    640x480, B=4 (n = S*B images, S-major)."""
    import torch
    import torch.nn.functional as Fn
    from mimo_unet_torch import kernels as K

    bf, f32 = torch.bfloat16, torch.float32
    n, hw, px = S * TB, TH * TW, S * TB * TH * TW
    c_up = F * S
    mid = (F + c_up) // 2

    def act(*shape, scale=1.0):
        return (torch.randn(shape, device=dev, generator=gen) * scale).to(bf)

    def weight(cin, o):
        return ((torch.rand((S, 3, 3, cin, o), device=dev, generator=gen) * 2 - 1)
                / (9 * cin) ** 0.5).to(bf).float()

    def affine(c):
        return (torch.rand((S, c), device=dev, generator=gen) + 0.5,
                torch.randn((S, c), device=dev, generator=gen) * 0.1)

    def lib_in(x1, x2=None):
        """The site's inputs as one NCHW (channels-last) tensor with the S
        groups on channels, reflect-padded: [B, S*C, H+2, W+2]."""
        z = x1.view(S, TB, TH, TW, -1)
        if x2 is not None:
            z = torch.cat([z, x2.unsqueeze(0).expand(S, *x2.shape)], dim=-1)
        z = z.permute(1, 0, 4, 2, 3).reshape(TB, -1, TH, TW)
        return Fn.pad(z, (1, 1, 1, 1), mode="reflect").contiguous(
            memory_format=torch.channels_last)

    def lib_w(w):  # [S, 3, 3, C, O] -> [S*O, C, 3, 3] bf16
        return w.permute(0, 4, 3, 1, 2).reshape(-1, w.shape[3], 3, 3).to(bf)

    def lib_g(g):  # [S*B, H, W, O] -> [B, S*O, H, W]
        return g.view(S, TB, TH, TW, -1).permute(1, 0, 4, 2, 3).reshape(
            TB, -1, TH, TW).contiguous(memory_format=torch.channels_last)

    sites = []
    # (label, x1, x2, w, prologue) per conv of the path
    x = act(n, TH, TW, 3)
    y1, x1s, y5 = act(n, TH, TW, F), act(n, TH, TW, F), act(n, TH, TW, mid)
    up = act(TB, TH, TW, c_up)
    convs = [
        ("in_conv.conv1 3->21", x, None, weight(3, F), None),
        ("in_conv.conv2 21->21 +prologue", y1, None, weight(F, F), affine(F)),
        ("decoder conv1 (21+42)->31 x2 period 4", x1s, up, weight(F + c_up, mid), None),
        ("decoder conv2 31->21 +prologue", y5, None, weight(mid, F), affine(mid)),
    ]
    for label, a1, a2, w, pro in convs:
        sc, sh = pro if pro is not None else (None, None)
        c1, cin, o = a1.shape[-1], w.shape[3], w.shape[4]
        n2 = 0 if a2 is None else a2.shape[0]
        conv_flops = 2.0 * px * 9 * cin * o
        in_bytes = _nbytes((a1.shape, 2)) + (0 if a2 is None else _nbytes((a2.shape, 2)))
        w_bytes = _nbytes((w.shape, 2))
        g = act(n, TH, TW, o, scale=0.01)
        ds = torch.randn((S, o), device=dev, generator=gen) * 1e-4
        dq = torch.randn((S, o), device=dev, generator=gen) * 1e-6
        xl, wl = lib_in(a1, a2), lib_w(w)
        gl = lib_g(g)
        sites.append(Site(
            "conv3x3_fwd", label,
            lambda a1=a1, a2=a2, w=w, sc=sc, sh=sh: K.conv3x3_fwd(a1, w, x2=a2, scale=sc, shift=sh),
            lambda a1=a1, a2=a2, w=w, sc=sc, sh=sh: K.conv3x3_fwd_plain(a1, w, x2=a2, scale=sc, shift=sh),
            False, conv_flops, in_bytes + w_bytes + _nbytes(((n, TH, TW, o), 2)),
            lambda xl=xl, wl=wl: Fn.conv2d(xl, wl, groups=S)))
        yk = K.conv3x3_fwd(a1, w, x2=a2, scale=sc, shift=sh)[0]
        sites.append(Site(
            "g_eff", f"{label}: y {o} ch",
            lambda g=g, yk=yk, ds=ds, dq=dq: K.g_eff(g, yk, ds, dq),
            lambda g=g, yk=yk, ds=ds, dq=dq: K.g_eff_plain(g, yk, ds, dq),
            False, 3.0 * px * o, 3 * _nbytes(((n, TH, TW, o), 2))))
        dx_shape = (TB, S * cin, TH, TW)
        if a2 is not None:
            sites.append(Site(
                "conv3x3_dx_fold", label,
                lambda g=g, w=w, c1=c1, n2=n2: K.conv3x3_dx_fold(g, w, c1, n2),
                lambda g=g, w=w, c1=c1, n2=n2: K.conv3x3_dx_fold_plain(g, w, c1, n2),
                False, 2.0 * px * 9 * o * cin,
                _nbytes(((n, TH, TW, o), 2)) + w_bytes + in_bytes,
                lambda gl=gl, wl=wl, dx_shape=dx_shape: torch.nn.grad.conv2d_input(
                    dx_shape, wl, gl, padding=1, groups=S)))
        elif sc is not None:
            sites.append(Site(
                "conv3x3_dx", label,
                lambda g=g, w=w, a1=a1, sc=sc, sh=sh: K.conv3x3_dx(g, w, x1=a1, scale=sc, shift=sh),
                lambda g=g, w=w, a1=a1, sc=sc, sh=sh: K.conv3x3_dx_plain(g, w, x1=a1, scale=sc, shift=sh),
                False, 2.0 * px * 9 * o * cin,
                _nbytes(((n, TH, TW, o), 2)) + w_bytes + 2 * in_bytes,
                lambda gl=gl, wl=wl, dx_shape=dx_shape: torch.nn.grad.conv2d_input(
                    dx_shape, wl, gl, padding=1, groups=S)))
        sites.append(Site(
            "conv3x3_dw", label,
            lambda g=g, a1=a1, a2=a2, sc=sc, sh=sh: K.conv3x3_dw(g, a1, S, x2=a2, scale=sc, shift=sh),
            lambda g=g, a1=a1, a2=a2, sc=sc, sh=sh: K.conv3x3_dw_plain(g, a1, S, x2=a2, scale=sc, shift=sh),
            False, conv_flops,
            in_bytes + _nbytes(((n, TH, TW, o), 2)) + _nbytes((w.shape, 4)),
            lambda xl=xl, wl=wl, gl=gl: torch.nn.grad.conv2d_weight(
                xl, wl.shape, gl, groups=S)))

    y2 = act(n, TH, TW, F, scale=3.0)
    sc2, sh2 = affine(F)
    dz = act(n, TH, TW, F, scale=0.01)
    elem = _nbytes(((n, TH, TW, F), 2))
    sites.append(Site("affine_relu", "in_conv output x1s 21 ch",
                      lambda: K.affine_relu(y2, sc2, sh2),
                      lambda: K.affine_relu_plain(y2, sc2, sh2),
                      False, 3.0 * px * F, 2 * elem))
    sites.append(Site("affine_relu_bwd", "in_conv output x1s 21 ch",
                      lambda: K.affine_relu_bwd(dz, y2, sc2, sh2),
                      lambda: K.affine_relu_bwd_plain(dz, y2, sc2, sh2),
                      False, 6.0 * px * F, 3 * elem))
    y6 = act(n, TH, TW, F, scale=3.0)
    sc6, sh6 = affine(F)
    wo = (torch.rand((S, F, 2), device=dev, generator=gen) * 2 - 1) / F ** 0.5
    bo = torch.randn((S, 2), device=dev, generator=gen) * 0.1
    gl_ = act(n, TH, TW, 2, scale=0.01)
    logits = _nbytes(((n, TH, TW, 2), 2))
    sites.append(Site("conv1x1_prelu", "decoder bn2 + ReLU + out-conv 21->2",
                      lambda: K.conv1x1_prelu(y6, sc6, sh6, wo, bo),
                      lambda: K.conv1x1_prelu_plain(y6, sc6, sh6, wo, bo),
                      False, px * (3.0 * F + 2.0 * F * 2), elem + logits))
    sites.append(Site("conv1x1_prelu_bwd", "decoder bn2 + ReLU + out-conv 21->2",
                      lambda: K.conv1x1_prelu_bwd(gl_, y6, sc6, sh6, wo),
                      lambda: K.conv1x1_prelu_bwd_plain(gl_, y6, sc6, sh6, wo),
                      False, px * (4.0 * F + 4.0 * F * 2), 2 * elem + logits))
    return sites


def check_kernels(sites, card):
    """Every site's kernel against its plain version; returns per-kernel
    {max_abs_err, ms, plain_ms, bound_ms, bound_by, library_ms}, the
    times summed over the call sites."""
    import torch

    stats = {}
    for st in sites:
        got = st.kern()
        torch.cuda.synchronize()
        err = compare(f"{st.name} [{st.site}]", got, st.plain(), st.exact)
        del got
        iters = 20 if st.exact else 5
        ms, plain_ms = cuda_ms(st.kern, iters), cuda_ms(st.plain, iters)
        lib_ms = cuda_ms(st.library, iters) if st.library is not None else None
        t_ops, t_bytes = st.flops / PEAK_FLOPS * 1e3, st.nbytes / PEAK_BYTES * 1e3
        bound = max(t_ops, t_bytes)
        rec = stats.setdefault(st.name, {
            "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "bound_by": None, "library_ms": None, "_ops_ms": 0.0, "_bytes_ms": 0.0})
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["ms"] += ms
        rec["plain_ms"] += plain_ms
        rec["bound_ms"] += bound
        rec["_ops_ms"] += t_ops
        rec["_bytes_ms"] += t_bytes
        if lib_ms is not None:
            rec["library_ms"] = (rec["library_ms"] or 0.0) + lib_ms
        lib = f", library {lib_ms:.4f} ms" if lib_ms is not None else ""
        print(f"kernel {st.name} [{st.site}]: max_abs_err {err} "
              f"({'bitwise' if st.exact else 'tolerance'}), {ms:.4f} ms vs plain "
              f"{plain_ms:.4f} ms{lib}, bound {bound:.4f} ms "
              f"({'bytes' if t_bytes >= t_ops else 'operations'}) ({card})",
              flush=True)
    for rec in stats.values():
        rec["bound_by"] = "bytes" if rec.pop("_bytes_ms") >= rec.pop("_ops_ms") else "operations"
    return stats


def serve(dev, card, ct_kernels="auto"):
    """The flagship served through an Ensemble; returns the eval kernels'
    launch counts over the requests."""
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
    print(f"serve launches: {launches}")
    missing = [k.__name__ for k in K.EVAL_KERNELS if launches[k.__name__] <= 0]
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


def _frames(gen, b):
    """Seeded random NYUv2-shaped uint8 frames and depth labels."""
    import torch

    return {"image": torch.randint(0, 256, (b, TH, TW, 3), generator=gen,
                                   dtype=torch.uint8),
            "label": torch.randint(0, 256, (b, TH, TW, 1), generator=gen,
                                   dtype=torch.uint8)}


def _grad_check(task, state, dev, card):
    """One step's loss and gradients: the kernel path against the plain
    model (ct_kernels="off") with the same weights and inputs, on copies
    of the train state's model."""
    import torch
    from mimo_unet_torch.loss_buffer import loss_buffer_init
    from mimo_unet_torch.tasks.mimo import device_normalize
    from mimo_unet_torch.transforms import apply_input_transform

    batch = device_normalize({k: v.to(dev) for k, v in
                              _frames(torch.Generator().manual_seed(5), TRAIN_B).items()})
    image_t, label_t, _ = apply_input_transform(
        torch.Generator().manual_seed(6), batch["image"], batch["label"], None, S)
    results = {}
    for ct in ("auto", "off"):
        t = dataclasses.replace(task, ct_kernels=ct)
        model = t.build_model(dev)
        model.load_state_dict(state.model.state_dict())
        model.train()
        loss = t.objective(model, image_t, label_t, None,
                           loss_buffer_init(S, t.loss_buffer_size, dev))[0]
        loss.backward()
        results[ct] = (float(loss.detach()), {k: p.grad.float() for k, p in
                                     model.named_parameters() if p.grad is not None})
        del model
    (lk, gk), (lp, gp) = results["auto"], results["off"]
    rel = abs(lk - lp) / abs(lp)
    print(f"grad check: loss kernels {lk} vs plain {lp} (rel {rel:.3e}) ({card})")
    if not rel <= 2e-2:
        raise AssertionError(f"train loss: kernel path {lk} vs plain {lp}")
    if gk.keys() != gp.keys():
        raise AssertionError(f"gradient leaves differ: {sorted(gk.keys() ^ gp.keys())}")
    cos = {}
    for k, b in gp.items():
        if float(b.abs().max()) < 5e-3:  # noise-level leaf
            continue
        a = gk[k]
        cos[k] = float((a * b).sum() / (a.norm() * b.norm() + 1e-12))
    worst = min(cos, key=cos.get)
    print(f"grad check: {len(cos)} leaves, cosine min {cos[worst]:.5f} ({worst}), "
          f"mean {sum(cos.values()) / len(cos):.5f}")
    low = {k: v for k, v in cos.items() if v < 0.99}
    if low:
        raise AssertionError(f"gradient cosine < 0.99: {low}")
    return cos


def _profile_step(task, state, batch, card):
    """Device time of one train step by phase, from torch.profiler's
    kernel events: the port's kernels, the optimizer, everything else."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    names = ("conv_fwd_kernel", "conv_dx_kernel", "conv_dw_kernel",
             "g_eff_kernel", "affine_relu", "conv1x1_prelu", "reduce_groups")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        task.train_step(state, batch)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    phases = {"port kernels": 0.0, "optimizer": 0.0, "other (core, glue)": 0.0}
    per_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        key = ev.key
        ours = [nm for nm in names if nm in key]
        if ours:
            phases["port kernels"] += us
            per_kernel[ours[0]] = per_kernel.get(ours[0], 0.0) + us
        elif "multi_tensor" in key or "adam" in key.lower() or "foreach" in key:
            phases["optimizer"] += us
        else:
            phases["other (core, glue)"] += us
    busy = sum(phases.values()) / 1e3
    print(f"profile B={TRAIN_B} step (profiled wall {wall:.1f} ms, device busy "
          f"{busy:.1f} ms): " + ", ".join(f"{k} {v / 1e3:.2f} ms"
                                          for k, v in phases.items()) + f" ({card})")
    for k, v in sorted(per_kernel.items(), key=lambda kv: -kv[1]):
        print(f"  {k}: {v / 1e3:.3f} ms")
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25,
                                    max_name_column_width=60))
    return phases


def _time_steps(task, state, gen, b, steps, card, label):
    import torch

    batches = [_frames(gen, b) for _ in range(2)]
    torch.cuda.reset_peak_memory_stats()
    task.train_step(state, batches[0])  # warm-up (cuDNN plans, allocator)
    torch.cuda.synchronize()
    times = []
    for i in range(steps):
        t0 = time.perf_counter()
        task.train_step(state, batches[i % 2])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    times.sort()
    med = times[len(times) // 2]
    print(f"train step {label} B={b}: median {med * 1e3:.2f} ms over {steps} "
          f"(min {times[0] * 1e3:.2f}), {b / med:.2f} images/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB ({card})",
          flush=True)
    return med


def train(dev, card):
    """Phase 6; returns the train kernels' launch counts over 3 steps."""
    import torch
    from mimo_unet_torch import kernels as K
    from mimo_unet_torch.tasks.mimo import MimoUnetTask

    task = MimoUnetTask(in_channels=3, out_channels=2, num_subnetworks=S,
                        filter_base_count=F, loss="laplace_nll",
                        learning_rate=1e-3, loss_buffer_size=10,
                        compute_dtype="bfloat16")
    spe = -(-795 // TRAIN_B)  # NYUv2's 795 training frames
    state = task.init_state(spe, dev)
    _grad_check(task, state, dev, card)
    torch.cuda.empty_cache()

    gen = torch.Generator().manual_seed(7)
    batches = [_frames(gen, TRAIN_B) for _ in range(3)]
    torch.cuda.synchronize()
    K.reset_launch_counts()
    for i, batch in enumerate(batches):
        state, logs, _ = task.train_step(state, batch)
        loss = float(logs["train_loss"])
        print(f"train step {i}: loss {loss:.5f}, weights "
              f"{float(logs['train_weight_0']):.4f} {float(logs['train_weight_1']):.4f}")
        if not torch.isfinite(torch.tensor(loss)):
            raise AssertionError(f"step {i}: non-finite loss")
    torch.cuda.synchronize()
    launches = K.launch_counts()
    print(f"train launches: {launches}")
    missing = [k.__name__ for k in K.TRAIN_KERNELS if launches[k.__name__] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the train path: {missing}")
    bad = [k for k, p in state.model.named_parameters()
           if not bool(torch.isfinite(p).all())]
    if bad:
        raise AssertionError(f"non-finite parameters after 3 steps: {bad}")
    if state.step != 3:
        raise AssertionError(f"train state step {state.step}")

    _profile_step(task, state, _frames(gen, TRAIN_B), card)
    _time_steps(task, state, gen, TRAIN_B, 5, card, "kernels")
    plain = dataclasses.replace(task, ct_kernels="off")
    pstate = plain.init_state(spe, dev)
    _time_steps(plain, pstate, gen, TRAIN_B, 5, card, "plain (cuDNN bf16)")
    del pstate
    torch.cuda.empty_cache()
    _time_steps(task, state, gen, BIG_B, 3, card, "kernels")
    del state
    torch.cuda.empty_cache()
    pstate = plain.init_state(spe, dev)
    _time_steps(plain, pstate, gen, BIG_B, 3, card, "plain (cuDNN bf16)")
    return launches


def main() -> int:
    import torch

    # ---- 1. the card ------------------------------------------------------
    # large steps (B=64 at 640x480) fragment the caching allocator
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
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
          f"({'nvcc ' + format(built, '.2f') + ' s' if built else 'cached'})",
          flush=True)

    # ---- 3-6 ----------------------------------------------------------------
    from mimo_unet_torch import kernels as K

    stats = check_kernels(
        eval_sites(dev, torch.Generator(device=dev).manual_seed(0)), card)
    torch.cuda.empty_cache()
    served = serve(dev, card)
    torch.cuda.empty_cache()
    stats.update(check_kernels(
        train_sites(dev, torch.Generator(device=dev).manual_seed(1)), card))
    torch.cuda.empty_cache()
    trained = train(dev, card)
    launches = {k.__name__: served[k.__name__] for k in K.EVAL_KERNELS}
    launches.update({k.__name__: trained[k.__name__] for k in K.TRAIN_KERNELS})

    # ---- 7. results --------------------------------------------------------
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
