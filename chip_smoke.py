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
   frames, S=2, fbc=21, B=4; down1's at 320x240), each output and
   gradient against its plain version at the same tolerance as phase 3.
6. Train: the NYUv2-depth task (S=2, fbc=21, bf16, Laplace NLL, lr 1e-3,
   loss buffer 10) at 640x480: ``init_state`` on the card, one step's loss
   and gradients against the plain model (ct_kernels="off", same weights:
   loss within 2e-2 relative, gradient cosine >= 0.99 per leaf above the
   noise threshold of tests/test_ct_train.py:228), then 3 ``train_step``s
   of B=16 seeded random uint8 frames whose launch counters must show
   every train kernel (K10 and K13 included) ran and whose loss and
   parameters stay finite; then
   a profile of one B=16 step (device time by phase and the top device
   operations) and step times at B=16 and B=64.
7. Dropout kernels: the grouped 1x1 (K11) forward at the MC-serving
   decoder site (N=64 images of 256x256: 8 images x 4 MC passes x S=2)
   and forward and backward at the 640x480 B=4 train site; affine_relu
   (K8) and conv1x1_prelu (K12), forward and backward, with per-image
   parameters (groups = N) at their 640x480 B=4 sites; each against its
   plain version at phase 3's tolerance; library calls ``torch.baddbmm``
   and, for K11's backward, its autograd backward.
8. MC serving: the flagship with the MC-dropout recipe (encoder, core and
   decoder Dropout2d at 0.1) in an ``Ensemble(monte_carlo_steps=4)``
   answers 8-image and 1-image ``predict`` requests (median latency); the
   launch counters must show K1-K4 and K11; the raw predictions must match
   the plain model (ct_kernels="off") drawing the same masks within
   3e-2 * max|ref|, and another generator must move them.
9. MC-recipe train at 640x480: one step's gradients against the plain
   model with the same masks (cosine >= 0.999 per leaf above the noise
   threshold, where the plain bf16 gradient is itself that close to the
   plain f32 model's; elsewhere no further from the f32 gradient than the
   plain bf16 model), 3 ``train_step``s of B=16 whose counters show the train
   kernels with K8 and K12 launched at groups = N, step times at B=16
   (kernels vs plain); then one B=4 ``train_step`` of the final-dropout
   route whose counters show K11's forward and backward, and its
   gradient check against the plain model.
10. Pool and upsample kernels: K10 (forward; backward with the skip
   cotangent, and once without) and K13 (forward, backward) at their
   256x256 B=64 (N = 128) and 640x480 B=4 train sites, against their
   plain versions: bitwise, but K13's backward at phase 3's tolerance;
   library calls ``F.max_pool2d`` and ``F.interpolate`` (bilinear,
   align_corners) on the channels-last tensor, and their backward.
11. Flagship train at 256x256 patches: the NYUv2-depth task of phase 6 on
   the train kernel route (``init_state`` on the card; one B=16 step's
   loss and gradients against the plain and f32 models as in phase 9),
   3 ``train_step``s at B=64 whose counters must show every train kernel
   and exactly 2 K10 forward, 2 K10 backward, 1 K13 forward and 1 K13
   backward launch per step, a profile of one B=64 step, and step times
   at B=16 and B=64 (kernels vs plain).
12. Partial tiles: the train kernels where their blocks do not divide the
   pixels (down1 of a 48x48 step at B=3: 4.5 conv tiles per 24x24 image,
   6.75 reducing blocks per group, 2.25 per image) and at fbc 40's
   channel counts, each against its plain version at phase 3's
   tolerance; then one B=3 48x48 step of the fbc-40 task on the kernel
   route (every train kernel and K10/K13 launched) with its loss and
   gradients against the plain and f32 models as in phase 9.
13. The x2-half train decoder (``MIMO_CT_TRAIN_X2_HALF=1``): K4b
   (``upsample_w2x_bwd``) and K14 (``lerp_h2x_transpose``) at the up4
   sites of the 256x256 B=64 and 640x480 B=4 steps, bitwise against
   their plain versions, beside their bounds and the autograd backward
   of ``F.interpolate`` (bilinear, align_corners) on the channels-last
   tensor; K5 and K7 with ``x2_half_h`` at dec.c1 (640x480 B=4) against
   their plain versions (phase 3's tolerance) and bitwise against their
   full-res form fed K13's output; 3 steps at 256x256 B=64 and 3 at
   640x480 B=16 whose counters must show 1 K4, 1 K4b, 1 K14, 0 K13 each
   way and 2 K10 each way per step, and every train kernel; one B=16
   256x256 step against the flag-off step on the same weights and inputs
   (logits, loss, running statistics and the decoder's gradients
   bitwise, every other gradient bitwise or no further from the flag-off
   one than a second flag-off run is); a profile of one B=64 step; step
   times and peak memory, flag on and off in turns, at 256x256 B=64 and
   640x480 B=16.
14. Print the kernels' JSON line (K10/K13 launches from phase 11, K4b and
   K14 from phase 13), then the result line ``{"ok": true, "device":
   {...}}`` last.

Every time carries the card's name and power limit.  Exits non-zero,
printing no result, without CUDA or outside the repo.
"""

from __future__ import annotations

import contextlib
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
NYU, PATCH = (TH, TW), (HW, HW)        # train frame sizes: NYUv2, flagship
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
    "conv1x1": ("mimo_unet_torch/csrc/train_elem.cu", _E + "ct_elem.py:437"),
    "conv1x1_bwd": ("mimo_unet_torch/csrc/train_elem.cu", _E + "ct_elem.py:464"),
    "max_pool2x2": ("mimo_unet_torch/csrc/pool2x2.cu", _E + "ct_elem.py:282"),
    "max_pool2x2_bwd": ("mimo_unet_torch/csrc/pool2x2.cu", _E + "ct_elem.py:336"),
    "upsample2x": ("mimo_unet_torch/csrc/upsample2x.cu", _E + "ct_resize.py:59"),
    "upsample2x_bwd": ("mimo_unet_torch/csrc/upsample2x.cu", _E + "ct_resize.py:124"),
    "upsample_w2x_bwd": ("mimo_unet_torch/csrc/upsample_w2x.cu", _E + "ct_resize.py:254"),
    "lerp_h2x_transpose": ("mimo_unet_torch/csrc/upsample2x.cu", _E + "ct_resize.py:295"),
}
X2_HALF = "MIMO_CT_TRAIN_X2_HALF"  # the x2-half train decoder's switch
# the documented MC-dropout recipe (reference Readme.md:82)
MC_RECIPE = dict(encoder_dropout_rate=0.1, core_dropout_rate=0.1,
                 decoder_dropout_rate=0.1)
MC_STEPS, MC_B = 4, 8                  # MC passes; images per MC request


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
    640x480, B=4 (n = S*B images, S-major); down1's at half resolution."""
    import torch
    import torch.nn.functional as Fn
    from mimo_unet_torch import kernels as K

    bf = torch.bfloat16
    n, px = S * TB, S * TB * TH * TW
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
        hh, ww = x1.shape[1:3]
        z = x1.view(S, TB, hh, ww, -1)
        if x2 is not None:
            z = torch.cat([z, x2.unsqueeze(0).expand(S, *x2.shape)], dim=-1)
        z = z.permute(1, 0, 4, 2, 3).reshape(TB, -1, hh, ww)
        return Fn.pad(z, (1, 1, 1, 1), mode="reflect").contiguous(
            memory_format=torch.channels_last)

    def lib_w(w):  # [S, 3, 3, C, O] -> [S*O, C, 3, 3] bf16
        return w.permute(0, 4, 3, 1, 2).reshape(-1, w.shape[3], 3, 3).to(bf)

    def lib_g(g):  # [S*B, H, W, O] -> [B, S*O, H, W]
        hh, ww = g.shape[1:3]
        return g.view(S, TB, hh, ww, -1).permute(1, 0, 4, 2, 3).reshape(
            TB, -1, hh, ww).contiguous(memory_format=torch.channels_last)

    sites = []
    # (label, x1, x2, w, prologue) per conv of the path; down1's conv1 is
    # the one without a prologue whose input needs a gradient (plain dx)
    h2, w2 = TH // 2, TW // 2
    x = act(n, TH, TW, 3)
    y1, x1s, y5 = act(n, TH, TW, F), act(n, TH, TW, F), act(n, TH, TW, mid)
    p1, y3 = act(n, h2, w2, F), act(n, h2, w2, 2 * F)
    up = act(TB, TH, TW, c_up)
    convs = [
        ("in_conv.conv1 3->21", x, None, weight(3, F), None),
        ("in_conv.conv2 21->21 +prologue", y1, None, weight(F, F), affine(F)),
        (f"down1.conv1 21->42 @{w2}x{h2}", p1, None, weight(F, 2 * F), None),
        (f"down1.conv2 42->42 +prologue @{w2}x{h2}", y3, None, weight(2 * F, 2 * F),
         affine(2 * F)),
        ("decoder conv1 (21+42)->31 x2 period 4", x1s, up, weight(F + c_up, mid), None),
        ("decoder conv2 31->21 +prologue", y5, None, weight(mid, F), affine(mid)),
    ]
    for label, a1, a2, w, pro in convs:
        sc, sh = pro if pro is not None else (None, None)
        c1, cin, o = a1.shape[-1], w.shape[3], w.shape[4]
        hh, ww = a1.shape[1:3]
        cpx = n * hh * ww
        n2 = 0 if a2 is None else a2.shape[0]
        conv_flops = 2.0 * cpx * 9 * cin * o
        in_bytes = _nbytes((a1.shape, 2)) + (0 if a2 is None else _nbytes((a2.shape, 2)))
        w_bytes = _nbytes((w.shape, 2))
        y_bytes = _nbytes(((n, hh, ww, o), 2))
        g = act(n, hh, ww, o, scale=0.01)
        ds = torch.randn((S, o), device=dev, generator=gen) * 1e-4
        dq = torch.randn((S, o), device=dev, generator=gen) * 1e-6
        xl, wl = lib_in(a1, a2), lib_w(w)
        gl = lib_g(g)
        sites.append(Site(
            "conv3x3_fwd", label,
            lambda a1=a1, a2=a2, w=w, sc=sc, sh=sh: K.conv3x3_fwd(a1, w, x2=a2, scale=sc, shift=sh),
            lambda a1=a1, a2=a2, w=w, sc=sc, sh=sh: K.conv3x3_fwd_plain(a1, w, x2=a2, scale=sc, shift=sh),
            False, conv_flops, in_bytes + w_bytes + y_bytes,
            lambda xl=xl, wl=wl: Fn.conv2d(xl, wl, groups=S)))
        yk = K.conv3x3_fwd(a1, w, x2=a2, scale=sc, shift=sh)[0]
        sites.append(Site(
            "g_eff", f"{label}: y {o} ch",
            lambda g=g, yk=yk, ds=ds, dq=dq: K.g_eff(g, yk, ds, dq),
            lambda g=g, yk=yk, ds=ds, dq=dq: K.g_eff_plain(g, yk, ds, dq),
            False, 3.0 * cpx * o, 3 * y_bytes))
        dx_shape = (TB, S * cin, hh, ww)
        if a2 is not None:
            sites.append(Site(
                "conv3x3_dx_fold", label,
                lambda g=g, w=w, c1=c1, n2=n2: K.conv3x3_dx_fold(g, w, c1, n2),
                lambda g=g, w=w, c1=c1, n2=n2: K.conv3x3_dx_fold_plain(g, w, c1, n2),
                False, conv_flops, y_bytes + w_bytes + in_bytes,
                lambda gl=gl, wl=wl, dx_shape=dx_shape: torch.nn.grad.conv2d_input(
                    dx_shape, wl, gl, padding=1, groups=S)))
        elif sc is not None or a1 is p1:  # down1's input needs its gradient
            sites.append(Site(
                "conv3x3_dx", label,
                lambda g=g, w=w, a1=a1, sc=sc, sh=sh: K.conv3x3_dx(g, w, x1=a1, scale=sc, shift=sh),
                lambda g=g, w=w, a1=a1, sc=sc, sh=sh: K.conv3x3_dx_plain(g, w, x1=a1, scale=sc, shift=sh),
                False, conv_flops,
                y_bytes + w_bytes + (1 if sc is None else 2) * in_bytes,
                lambda gl=gl, wl=wl, dx_shape=dx_shape: torch.nn.grad.conv2d_input(
                    dx_shape, wl, gl, padding=1, groups=S)))
        sites.append(Site(
            "conv3x3_dw", label,
            lambda g=g, a1=a1, a2=a2, sc=sc, sh=sh: K.conv3x3_dw(g, a1, S, x2=a2, scale=sc, shift=sh),
            lambda g=g, a1=a1, a2=a2, sc=sc, sh=sh: K.conv3x3_dw_plain(g, a1, S, x2=a2, scale=sc, shift=sh),
            False, conv_flops,
            in_bytes + y_bytes + _nbytes((w.shape, 4)),
            lambda xl=xl, wl=wl, gl=gl: torch.nn.grad.conv2d_weight(
                xl, wl.shape, gl, groups=S)))

    for label, hh, ww, c in (("in_conv output x1s 21 ch", TH, TW, F),
                             (f"down1 output 42 ch @{w2}x{h2}", h2, w2, 2 * F)):
        y2 = act(n, hh, ww, c, scale=3.0)
        sc2, sh2 = affine(c)
        dz = act(n, hh, ww, c, scale=0.01)
        elem = _nbytes(((n, hh, ww, c), 2))
        sites.append(Site("affine_relu", label,
                          lambda y2=y2, sc2=sc2, sh2=sh2: K.affine_relu(y2, sc2, sh2),
                          lambda y2=y2, sc2=sc2, sh2=sh2: K.affine_relu_plain(y2, sc2, sh2),
                          False, 3.0 * n * hh * ww * c, 2 * elem))
        sites.append(Site("affine_relu_bwd", label,
                          lambda dz=dz, y2=y2, sc2=sc2, sh2=sh2: K.affine_relu_bwd(dz, y2, sc2, sh2),
                          lambda dz=dz, y2=y2, sc2=sc2, sh2=sh2: K.affine_relu_bwd_plain(dz, y2, sc2, sh2),
                          False, 6.0 * n * hh * ww * c, 3 * elem))
    elem = _nbytes(((n, TH, TW, F), 2))
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


def dropout_kernel_sites(dev, gen):
    """K11 at its call sites (models/fast_path.py: the MC-dropout eval
    decoder, N = S*8*4 at 256x256; the final-dropout train decoder, N = S*4
    at 640x480) and K8/K12 with per-image parameters (groups = N) at their
    640x480 B=4 train sites, as the Dropout2d sites fold into them."""
    import torch
    from mimo_unet_torch import kernels as K

    bf = torch.bfloat16
    sites = []

    def act(*shape, scale=1.0):
        return (torch.randn(shape, device=dev, generator=gen) * scale).to(bf)

    def out_conv(groups):
        return ((torch.rand((groups, F, 2), device=dev, generator=gen) * 2 - 1) / F ** 0.5,
                torch.randn((groups, 2), device=dev, generator=gen) * 0.1)

    def baddbmm(z, wo, bo):  # one library call of the grouped 1x1
        g = wo.shape[0]
        return torch.baddbmm(bo.to(bf)[:, None, :], z.view(g, -1, z.shape[-1]),
                             wo.to(bf))

    def baddbmm_backward(g, z, wo, bo):  # its autograd backward, z, wo and bo
        args = [t.detach().requires_grad_() for t in (z, wo.to(bf), bo.to(bf))]
        out = baddbmm(*args)
        gl = g.view(out.shape)
        return lambda: torch.autograd.grad(out, args, gl, retain_graph=True)

    n_mc = S * MC_B * MC_STEPS
    z = act(n_mc, HW, HW, F)
    wo, bo = out_conv(S)
    px = n_mc * HW * HW
    sites.append(Site("conv1x1", f"MC decoder 21->2, N={n_mc} @256",
                      lambda: K.conv1x1(z, wo, bo), lambda: K.conv1x1_plain(z, wo, bo),
                      False, 2.0 * px * F * 2,
                      _nbytes((z.shape, 2), ((n_mc, HW, HW, 2), 2)),
                      lambda: baddbmm(z, wo, bo)))

    n, px = S * TB, S * TB * TH * TW
    elem, logits = _nbytes(((n, TH, TW, F), 2)), _nbytes(((n, TH, TW, 2), 2))
    zt = act(n, TH, TW, F)
    gt = act(n, TH, TW, 2, scale=0.01)
    sites.append(Site("conv1x1", f"final-dropout decoder 21->2, N={n} @640x480",
                      lambda: K.conv1x1(zt, wo, bo), lambda: K.conv1x1_plain(zt, wo, bo),
                      False, 2.0 * px * F * 2, elem + logits,
                      lambda: baddbmm(zt, wo, bo)))
    sites.append(Site("conv1x1_bwd", f"final-dropout decoder 21->2, N={n} @640x480",
                      lambda: K.conv1x1_bwd(gt, zt, wo),
                      lambda: K.conv1x1_bwd_plain(gt, zt, wo),
                      False, px * (4.0 * F * 2 + 2), 2 * elem + logits,
                      baddbmm_backward(gt, zt, wo, bo)))

    # per-image affine: the per-group BN affine times each image's
    # Dropout2d scale (0 or 1/keep)
    keep = 0.9
    m = (torch.rand((n, F), device=dev, generator=gen) < keep).float() / keep
    sc = (torch.rand((S, F), device=dev, generator=gen) + 0.5).repeat_interleave(TB, 0) * m
    sh = (torch.randn((S, F), device=dev, generator=gen) * 0.1).repeat_interleave(TB, 0) * m
    y = act(n, TH, TW, F, scale=3.0)
    dz = act(n, TH, TW, F, scale=0.01)
    wo_i, bo_i = wo.repeat_interleave(TB, 0), bo.repeat_interleave(TB, 0)
    sites.append(Site("affine_relu", f"in_conv x1s 21 ch, groups={n}",
                      lambda: K.affine_relu(y, sc, sh),
                      lambda: K.affine_relu_plain(y, sc, sh),
                      False, 3.0 * px * F, 2 * elem))
    sites.append(Site("affine_relu_bwd", f"in_conv x1s 21 ch, groups={n}",
                      lambda: K.affine_relu_bwd(dz, y, sc, sh),
                      lambda: K.affine_relu_bwd_plain(dz, y, sc, sh),
                      False, 6.0 * px * F, 3 * elem))
    sites.append(Site("conv1x1_prelu", f"decoder up4 Dropout2d + out-conv, groups={n}",
                      lambda: K.conv1x1_prelu(y, sc, sh, wo_i, bo_i),
                      lambda: K.conv1x1_prelu_plain(y, sc, sh, wo_i, bo_i),
                      False, px * (3.0 * F + 2.0 * F * 2), elem + logits))
    sites.append(Site("conv1x1_prelu_bwd", f"decoder up4 Dropout2d + out-conv, groups={n}",
                      lambda: K.conv1x1_prelu_bwd(gt, y, sc, sh, wo_i),
                      lambda: K.conv1x1_prelu_bwd_plain(gt, y, sc, sh, wo_i),
                      False, px * (4.0 * F + 4.0 * F * 2), 2 * elem + logits))
    return sites


def resample_sites(dev, gen):
    """K10 and K13 at their train call sites (models/fast_path.py
    ``mimo_unet_apply_train``): the flagship 256x256 step at B=64 (N = S*B
    = 128 images) and the 640x480 step at B=4.  The pool's input is a ReLU
    output, so all-zero windows tie; the pool's backward runs with the
    skip cotangent, as both sites run it, and once without at 640x480.
    Library calls: ``F.max_pool2d`` and ``F.interpolate`` (bilinear,
    align_corners) on the channels-last tensor, and their autograd
    backward."""
    import torch
    import torch.nn.functional as Fn
    from mimo_unet_torch import kernels as K

    bf = torch.bfloat16

    def act(*shape, relu=False):
        t = torch.randn(shape, device=dev, generator=gen)
        return (t.clamp_min(0) if relu else t).to(bf)

    def nchw(t):  # an NCHW view of a channels-last tensor
        return t.permute(0, 3, 1, 2)

    def backward_of(fn, x, g):
        """One library backward: autograd of ``fn`` at x against g."""
        xl = nchw(x).detach().requires_grad_()
        out, gl = fn(xl), nchw(g)
        return lambda: torch.autograd.grad(out, xl, gl, retain_graph=True)

    def pool(t):
        return Fn.max_pool2d(t, 2)

    def interp(t):
        return Fn.interpolate(t, scale_factor=2, mode="bilinear", align_corners=True)

    sites = []
    for b, (h, w) in ((BIG_B, PATCH), (TB, NYU)):
        n, tag = S * b, f"{h}x{w} B={b}"
        for label, c, hh, ww in (("in_conv -> down1", F, h, w),
                                 ("down1 -> core", 2 * F, h // 2, w // 2)):
            x = act(n, hh, ww, c, relu=True)
            y, g, gs = K.max_pool2x2(x), act(n, hh // 2, ww // 2, c), act(n, hh, ww, c)
            full = _nbytes(((n, hh, ww, c), 2))
            half = full / 4
            sites.append(Site(
                "max_pool2x2", f"{label} {tag} [{n},{hh},{ww},{c}]",
                lambda x=x: K.max_pool2x2(x), lambda x=x: K.max_pool2x2_plain(x),
                True, 0.75 * x.numel(), full + half, lambda x=x: pool(nchw(x))))
            sites.append(Site(
                "max_pool2x2_bwd", f"{label} {tag} +skip",
                lambda g=g, x=x, y=y, gs=gs: K.max_pool2x2_bwd(g, x, y, gs),
                lambda g=g, x=x, y=y, gs=gs: K.max_pool2x2_bwd_plain(g, x, y, gs),
                True, 2.0 * x.numel(), 3 * full + 2 * half, backward_of(pool, x, g)))
            if b == TB and c == 2 * F:
                sites.append(Site(
                    "max_pool2x2_bwd", f"{label} {tag} no skip",
                    lambda g=g, x=x, y=y: K.max_pool2x2_bwd(g, x, y),
                    lambda g=g, x=x, y=y: K.max_pool2x2_bwd_plain(g, x, y),
                    True, 1.0 * x.numel(), 2 * full + 2 * half, backward_of(pool, x, g)))
        c_up = F * S  # the core's output channels
        xu, gu = act(b, h // 2, w // 2, c_up), act(b, h, w, c_up)
        big = _nbytes((gu.shape, 2))
        sites.append(Site(
            "upsample2x", f"decoder input {tag} [{b},{h // 2},{w // 2},{c_up}]",
            lambda xu=xu: K.upsample2x(xu), lambda xu=xu: K.upsample2x_plain(xu),
            True, 9.0 * gu.numel(), 1.25 * big, lambda xu=xu: interp(nchw(xu))))
        sites.append(Site(
            "upsample2x_bwd", f"decoder input {tag}",
            lambda gu=gu: K.upsample2x_bwd(gu), lambda gu=gu: K.upsample2x_bwd_plain(gu),
            False, 7.5 * gu.numel(), 1.25 * big, backward_of(interp, xu, gu)))
    return sites


def tail_sites(dev, gen):
    """The train kernels at shapes their blocks do not divide: down1 of a
    48x48 step at B=3 (N = 6 images of 24x24 = 576 pixels: 4.5 of the conv
    kernels' 128-pixel tiles per image, 6.75 of the reducing passes'
    256-pixel blocks per group, 2.25 per image at groups = N) with fbc
    40's 40 -> 80 channels, and the 1x1 kernels at that pixel count."""
    import torch
    from mimo_unet_torch import kernels as K

    bf = torch.bfloat16
    n, hh, ww, f = S * 3, 24, 24, 40

    def act(*shape, scale=1.0):
        return (torch.randn(shape, device=dev, generator=gen) * scale).to(bf)

    def weight(cin, o):
        return ((torch.rand((S, 3, 3, cin, o), device=dev, generator=gen) * 2 - 1)
                / (9 * cin) ** 0.5).to(bf).float()

    def affine(groups, c):
        return (torch.rand((groups, c), device=dev, generator=gen) + 0.5,
                torch.randn((groups, c), device=dev, generator=gen) * 0.1)

    sites = []

    def add(name, label, kern, plain):
        sites.append(Site(name, label, kern, plain, False, 0.0, 0.0))

    p1, y3, x1s = act(n, hh, ww, f), act(n, hh, ww, 2 * f), act(n, hh, ww, 8)
    up = act(n // S, hh, ww, 16)
    w1, w2, wd = weight(f, 2 * f), weight(2 * f, 2 * f), weight(24, 12)
    sc, sh = affine(S, 2 * f)
    g1, gd = act(n, hh, ww, 2 * f, scale=0.01), act(n, hh, ww, 12, scale=0.01)
    tag = f"[{n},{hh},{ww}]"
    add("conv3x3_fwd", f"down1.conv1 40->80 {tag}",
        lambda: K.conv3x3_fwd(p1, w1), lambda: K.conv3x3_fwd_plain(p1, w1))
    add("conv3x3_fwd", f"down1.conv2 80->80 +prologue {tag}",
        lambda: K.conv3x3_fwd(y3, w2, scale=sc, shift=sh),
        lambda: K.conv3x3_fwd_plain(y3, w2, scale=sc, shift=sh))
    add("conv3x3_dx", f"down1.conv1 {tag}",
        lambda: K.conv3x3_dx(g1, w1), lambda: K.conv3x3_dx_plain(g1, w1))
    add("conv3x3_dx", f"down1.conv2 +prologue {tag}",
        lambda: K.conv3x3_dx(g1, w2, x1=y3, scale=sc, shift=sh),
        lambda: K.conv3x3_dx_plain(g1, w2, x1=y3, scale=sc, shift=sh))
    add("conv3x3_dx_fold", f"(8+16)->12 x2 period {n // S} {tag}",
        lambda: K.conv3x3_dx_fold(gd, wd, 8, n // S),
        lambda: K.conv3x3_dx_fold_plain(gd, wd, 8, n // S))
    add("conv3x3_dw", f"down1.conv1 {tag}",
        lambda: K.conv3x3_dw(g1, p1, S), lambda: K.conv3x3_dw_plain(g1, p1, S))
    add("conv3x3_dw", f"down1.conv2 +prologue {tag}",
        lambda: K.conv3x3_dw(g1, y3, S, scale=sc, shift=sh),
        lambda: K.conv3x3_dw_plain(g1, y3, S, scale=sc, shift=sh))
    y4, dz = act(n, hh, ww, 2 * f, scale=3.0), act(n, hh, ww, 2 * f, scale=0.01)
    z, gl = act(n, hh, ww, f, scale=3.0), act(n, hh, ww, 2, scale=0.01)
    for groups in (S, n):
        sc4, sh4 = affine(groups, 2 * f)
        add("affine_relu_bwd", f"down1 80 ch, groups={groups} {tag}",
            lambda sc4=sc4, sh4=sh4: K.affine_relu_bwd(dz, y4, sc4, sh4),
            lambda sc4=sc4, sh4=sh4: K.affine_relu_bwd_plain(dz, y4, sc4, sh4))
        sc6, sh6 = affine(groups, f)
        wo = (torch.rand((groups, f, 2), device=dev, generator=gen) * 2 - 1) / f ** 0.5
        bo = torch.randn((groups, 2), device=dev, generator=gen) * 0.1
        add("conv1x1_prelu", f"40->2, groups={groups} {tag}",
            lambda sc6=sc6, sh6=sh6, wo=wo, bo=bo: K.conv1x1_prelu(z, sc6, sh6, wo, bo),
            lambda sc6=sc6, sh6=sh6, wo=wo, bo=bo: K.conv1x1_prelu_plain(z, sc6, sh6, wo, bo))
        add("conv1x1_prelu_bwd", f"40->2, groups={groups} {tag}",
            lambda sc6=sc6, sh6=sh6, wo=wo: K.conv1x1_prelu_bwd(gl, z, sc6, sh6, wo),
            lambda sc6=sc6, sh6=sh6, wo=wo: K.conv1x1_prelu_bwd_plain(gl, z, sc6, sh6, wo))
        add("conv1x1", f"40->2, groups={groups} {tag}",
            lambda wo=wo, bo=bo: K.conv1x1(z, wo, bo),
            lambda wo=wo, bo=bo: K.conv1x1_plain(z, wo, bo))
        add("conv1x1_bwd", f"40->2, groups={groups} {tag}",
            lambda wo=wo: K.conv1x1_bwd(gl, z, wo),
            lambda wo=wo: K.conv1x1_bwd_plain(gl, z, wo))
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


def _flagship(dev, **rates):
    """The flagship serving task (S=2, fbc=21, bf16, Laplace NLL) with
    dropout ``rates`` and its model: seeded weights, random BatchNorm
    statistics."""
    import torch
    from mimo_unet_torch.tasks.mimo import MimoUnetTask

    task = MimoUnetTask(in_channels=3, out_channels=2, num_subnetworks=S,
                        filter_base_count=F, loss="laplace_nll",
                        compute_dtype="bfloat16", **rates)
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
    return task, model


def _plain_copy(task, model, dev):
    """The same model on the plain modules (ct_kernels="off")."""
    off_task = dataclasses.replace(task, ct_kernels="off")
    off_model = off_task.build_model(dev)
    off_model.load_state_dict(model.state_dict())
    return off_task, off_model


def serve(dev, card):
    """The flagship served through an Ensemble; returns the eval kernels'
    launch counts over the requests."""
    import torch
    from mimo_unet_torch import kernels as K
    from mimo_unet_torch.models.ensemble import Ensemble

    task, model = _flagship(dev)
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

    off = Ensemble([_plain_copy(task, model, dev)])
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


def serve_mc(dev, card):
    """Phase 8: MC-dropout serving; returns the launch counts over the
    requests."""
    import torch
    from mimo_unet_torch import kernels as K
    from mimo_unet_torch.models.ensemble import Ensemble

    task, model = _flagship(dev, **MC_RECIPE)
    ens = Ensemble([(task, model)], monte_carlo_steps=MC_STEPS,
                   generator=torch.Generator(dev).manual_seed(3))
    rng = torch.Generator().manual_seed(4)
    sizes = [MC_B] * 5 + [1] * 5
    requests = [torch.rand((b, HW, HW, 3), generator=rng).numpy() for b in sizes]
    for b in (MC_B, 1):  # warm-up: cuDNN plans per shape
        ens.predict(requests[sizes.index(b)], batch_size=b)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    times = {MC_B: [], 1: []}
    answers = []
    for req in requests:
        t0 = time.perf_counter()
        answers.append(ens.predict(req, batch_size=req.shape[0]))
        times[req.shape[0]].append(time.perf_counter() - t0)
    launches = K.launch_counts()
    for b, ts in times.items():
        ts.sort()
        print(f"MC predict B={b} x {MC_STEPS} passes: median {ts[len(ts) // 2] * 1e3:.3f} ms "
              f"over {len(ts)} (min {ts[0] * 1e3:.3f}) ({card})")
    print(f"MC serve launches: {launches}")
    missing = [k.__name__ for k in K.EVAL_KERNELS + (K.conv1x1,)
               if launches[k.__name__] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the MC serving path: {missing}")
    for req, outs in zip(requests, answers):
        for arr in outs:
            if (arr.shape != (req.shape[0], HW, HW, 1)
                    or not torch.isfinite(torch.from_numpy(arr)).all()):
                raise AssertionError(f"MC predict: shape {arr.shape} or non-finite")

    # the raw predictions against the plain model drawing the same masks
    off = Ensemble([_plain_copy(task, model, dev)], monte_carlo_steps=MC_STEPS,
                   generator=torch.Generator(dev).manual_seed(5))
    image = torch.from_numpy(requests[0]).to(dev)
    ens.generator.manual_seed(5)
    got = ens.raw_forward(image)
    want = off.raw_forward(image)
    for name, g, w in zip(("p1", "p2"), got, want):
        if g.shape != (MC_B, S * MC_STEPS, HW, HW, 1):
            raise AssertionError(f"MC {name}: shape {tuple(g.shape)}")
        scale = float(w.abs().max()) or 1.0
        err = float((g - w).abs().max())
        print(f"MC serve {name}: max abs vs ct_kernels=off {err} (scale {scale})")
        if err > 3e-2 * scale:
            raise AssertionError(f"MC {name}: kernel path vs plain {err} > 3e-2 * {scale}")
    ens.generator.manual_seed(6)
    moved = float((ens.raw_forward(image)[0] - got[0]).abs().max())
    print(f"MC serve: another generator moves p1 by {moved}")
    if not moved > 1e-2 * float(got[0].abs().max()):
        raise AssertionError("MC serving: the dropout sites are not live")
    return launches


def _frames(gen, b, hw=NYU):
    """Seeded random uint8 frames and depth labels of size ``hw``."""
    import torch

    return {"image": torch.randint(0, 256, (b, *hw, 3), generator=gen,
                                   dtype=torch.uint8),
            "label": torch.randint(0, 256, (b, *hw, 1), generator=gen,
                                   dtype=torch.uint8)}


def _cos(a, b):
    return float((a * b).sum() / (a.norm() * b.norm() + 1e-12))


def _grad_check(task, state, dev, card, b=TRAIN_B, min_cos=0.99, f32_ref=False,
                hw=NYU):
    """One step's loss and gradients: the kernel path against the plain
    model (ct_kernels="off") with the same weights, inputs and dropout
    masks, on copies of the train state's model: cosine >= ``min_cos`` on
    every leaf above the noise threshold.  ``f32_ref`` also runs the plain
    model in float32: a leaf whose plain bf16 gradient is itself further
    than ``min_cos`` from the f32 one is set by bf16 rounding, not by the
    kernels, and there the kernel path must be as close to the f32
    gradient as the plain model is, up to tests/test_torch_train.py's slack
    (0.15 on the minimum, 0.05 on the mean over those leaves)."""
    import torch
    from mimo_unet_torch.loss_buffer import loss_buffer_init
    from mimo_unet_torch.models.mimo_unet import dropout_sites
    from mimo_unet_torch.ops.dropout import DropoutSource
    from mimo_unet_torch.tasks.mimo import device_normalize
    from mimo_unet_torch.transforms import apply_input_transform

    batch = device_normalize({k: v.to(dev) for k, v in
                              _frames(torch.Generator().manual_seed(5), b, hw).items()})
    image_t, label_t, _ = apply_input_transform(
        torch.Generator().manual_seed(6), batch["image"], batch["label"], None, S)
    sites = dropout_sites(task.model_config, image_t.shape[0], *hw)
    source = None
    if sites:  # one draw, given to every run
        drawn = DropoutSource(torch.Generator(dev).manual_seed(8)).draw(sites, dev)
        source = DropoutSource(masks={k: m for k, (m, _) in drawn.items()})
    runs = {"kernels": dict(ct_kernels="auto"), "plain": dict(ct_kernels="off")}
    if f32_ref:
        runs["f32"] = dict(ct_kernels="off", compute_dtype=None)
    results = {}
    for name, kw in runs.items():
        t = dataclasses.replace(task, **kw)
        model = t.build_model(dev)
        model.load_state_dict(state.model.state_dict())
        model.train()
        loss = t.objective(model, image_t, label_t, None,
                           loss_buffer_init(S, t.loss_buffer_size, dev), source)[0]
        loss.backward()
        results[name] = (float(loss.detach()), {k: p.grad.float() for k, p in
                                       model.named_parameters() if p.grad is not None})
        del model
    (lk, gk), (lp, gp) = results["kernels"], results["plain"]
    rel = abs(lk - lp) / abs(lp)
    print(f"grad check {hw[0]}x{hw[1]} B={b}: loss kernels {lk} vs plain {lp} "
          f"(rel {rel:.3e}) ({card})")
    if not rel <= 2e-2:
        raise AssertionError(f"train loss: kernel path {lk} vs plain {lp}")
    if gk.keys() != gp.keys():
        raise AssertionError(f"gradient leaves differ: {sorted(gk.keys() ^ gp.keys())}")
    cos = {k: _cos(gk[k], g) for k, g in gp.items()
           if float(g.abs().max()) >= 5e-3}  # else a noise-level leaf
    worst = min(cos, key=cos.get)
    print(f"grad check: {len(cos)} leaves, cosine min {cos[worst]:.5f} ({worst}), "
          f"mean {sum(cos.values()) / len(cos):.5f}")
    noisy = []
    if f32_ref:
        g32 = results["f32"][1]
        print(f"grad check: loss f32 {results['f32'][0]}")
        c_k = {k: _cos(gk[k], g32[k]) for k in cos}
        c_p = {k: _cos(gp[k], g32[k]) for k in cos}
        noisy = [k for k in cos if c_p[k] < min_cos]
        for k in noisy:
            print(f"  bf16-noisy leaf {k}: vs f32 kernels {c_k[k]:.5f}, plain "
                  f"{c_p[k]:.5f}; kernels vs plain {cos[k]:.5f}")
        if noisy:
            mk, mp = min(c_k[k] for k in noisy), min(c_p[k] for k in noisy)
            ak = sum(c_k[k] for k in noisy) / len(noisy)
            ap = sum(c_p[k] for k in noisy) / len(noisy)
            print(f"grad check: {len(noisy)} bf16-noisy leaves, cosine to f32 "
                  f"min kernels {mk:.5f} vs plain {mp:.5f}, mean {ak:.5f} vs {ap:.5f}")
            if mk < mp - 0.15 or ak < ap - 0.05:
                raise AssertionError("kernel path further from the f32 gradients "
                                     "than the plain bf16 model")
    clean = {k: v for k, v in cos.items() if k not in noisy}
    if noisy:
        print(f"grad check: {len(clean)} other leaves, cosine min "
              f"{min(clean.values()):.5f}, mean {sum(clean.values()) / len(clean):.5f}")
    low = {k: v for k, v in clean.items() if v < min_cos}
    if low:
        raise AssertionError(f"gradient cosine < {min_cos}: {low}")
    return cos


def _profile_step(task, state, batch, card, label):
    """Device time of one train step by phase, from torch.profiler's
    kernel events: the port's kernels, the optimizer, everything else."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    names = ("conv_fwd_kernel", "conv_dx_kernel", "conv_dw_kernel",
             "g_eff_kernel", "affine_relu", "conv1x1", "reduce_groups",
             "pool2x2_kernel", "pool2x2_bwd", "up2_fwd_kernel", "up2_bwd_kernel",
             "upsample_w2x_kernel", "upsample_w2x_bwd_kernel", "lerp_h2x_t_kernel")
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
    print(f"profile {label} step (profiled wall {wall:.1f} ms, device busy "
          f"{busy:.1f} ms): " + ", ".join(f"{k} {v / 1e3:.2f} ms"
                                          for k, v in phases.items()) + f" ({card})")
    for k, v in sorted(per_kernel.items(), key=lambda kv: -kv[1]):
        print(f"  {k}: {v / 1e3:.3f} ms")
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25,
                                    max_name_column_width=60))
    return phases


def _time_steps(task, state, gen, b, steps, card, label, hw=NYU):
    import torch

    batches = [_frames(gen, b, hw) for _ in range(2)]
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
    print(f"train step {hw[0]}x{hw[1]} {label} B={b}: median {med * 1e3:.2f} ms over {steps} "
          f"(min {times[0] * 1e3:.2f}), {b / med:.2f} images/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB ({card})",
          flush=True)
    return med


def train(dev, card):
    """Phase 6; returns the train kernels' launch counts over 3 steps."""
    import torch
    from mimo_unet_torch import kernels as K

    task = _train_task()
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
    missing = [k.__name__ for k in K.TRAIN_KERNELS + K.RESAMPLE_KERNELS
               if launches[k.__name__] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the train path: {missing}")
    bad = [k for k, p in state.model.named_parameters()
           if not bool(torch.isfinite(p).all())]
    if bad:
        raise AssertionError(f"non-finite parameters after 3 steps: {bad}")
    if state.step != 3:
        raise AssertionError(f"train state step {state.step}")

    _profile_step(task, state, _frames(gen, TRAIN_B), card, f"640x480 B={TRAIN_B}")
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


def _train_task(**rates):
    """The NYUv2-depth train task: S=2, fbc=21, bf16, Laplace NLL, lr 1e-3,
    loss buffer 10, with dropout ``rates``."""
    from mimo_unet_torch.tasks.mimo import MimoUnetTask

    return MimoUnetTask(in_channels=3, out_channels=2, num_subnetworks=S,
                        filter_base_count=F, loss="laplace_nll",
                        learning_rate=1e-3, loss_buffer_size=10,
                        compute_dtype="bfloat16", **rates)


def train_patch(dev, card):
    """Phase 11: the flagship step at 256x256 patches; returns the launch
    counts over 3 B=64 steps."""
    import torch
    from mimo_unet_torch import kernels as K
    from mimo_unet_torch.models.fast_path import train_path_supported

    task = _train_task()
    if not train_path_supported(task.model_config, (BIG_B, S, *PATCH, 3), dev,
                                training=True):
        raise AssertionError("256x256 does not take the train kernel route")
    spe = -(-795 // BIG_B)
    state = task.init_state(spe, dev)
    _grad_check(task, state, dev, card, f32_ref=True, hw=PATCH)
    torch.cuda.empty_cache()

    gen = torch.Generator().manual_seed(10)
    batches = [_frames(gen, BIG_B, PATCH) for _ in range(3)]
    torch.cuda.synchronize()
    K.reset_launch_counts()
    for i, batch in enumerate(batches):
        state, logs, _ = task.train_step(state, batch)
        loss = float(logs["train_loss"])
        print(f"256x256 train step {i} B={BIG_B}: loss {loss:.5f}")
        if not torch.isfinite(torch.tensor(loss)):
            raise AssertionError(f"256x256 step {i}: non-finite loss")
    torch.cuda.synchronize()
    launches = K.launch_counts()
    print(f"256x256 train launches: {launches}")
    missing = [k.__name__ for k in K.TRAIN_KERNELS if launches[k.__name__] <= 0]
    # per step: two pools (in_conv -> down1, down1 -> core), one upsample
    per_step = {"max_pool2x2": 2, "max_pool2x2_bwd": 2, "upsample2x": 1,
                "upsample2x_bwd": 1}
    wrong = {k: launches[k] for k, v in per_step.items() if launches[k] != 3 * v}
    if missing or wrong:
        raise AssertionError(f"256x256 train launches: missing {missing}, "
                             f"K10/K13 counts {wrong} (want {per_step} per step)")
    if not all(bool(torch.isfinite(p).all()) for p in state.model.parameters()):
        raise AssertionError("non-finite parameters after 3 256x256 steps")

    _profile_step(task, state, _frames(gen, BIG_B, PATCH), card, f"256x256 B={BIG_B}")
    plain = dataclasses.replace(task, ct_kernels="off")
    for b, steps in ((TRAIN_B, 5), (BIG_B, 3)):
        _time_steps(task, state, gen, b, steps, card, "kernels", PATCH)
        pstate = plain.init_state(spe, dev)
        _time_steps(plain, pstate, gen, b, steps, card, "plain (cuDNN bf16)", PATCH)
        del pstate
        torch.cuda.empty_cache()
    return launches


def train_tail(dev, card):
    """Phase 12: the tail sites against their plain versions, then one
    48x48 B=3 step of the fbc-40 task on the kernel route."""
    import torch
    from mimo_unet_torch import kernels as K
    from mimo_unet_torch.models.fast_path import train_path_supported

    for st in tail_sites(dev, torch.Generator(device=dev).manual_seed(4)):
        err = compare(f"{st.name} [{st.site}]", st.kern(), st.plain(), False)
        print(f"tail {st.name} [{st.site}]: max_abs_err {err} (tolerance)")
    task = dataclasses.replace(_train_task(), filter_base_count=40)
    b, hw = 3, (48, 48)
    if not train_path_supported(task.model_config, (b, S, *hw, 3), dev,
                                training=True):
        raise AssertionError("48x48 fbc 40 does not take the train kernel route")
    state = task.init_state(1, dev)
    K.reset_launch_counts()
    _grad_check(task, state, dev, card, b=b, f32_ref=True, hw=hw)
    launches = K.launch_counts()
    missing = [k.__name__ for k in K.TRAIN_KERNELS + K.RESAMPLE_KERNELS
               if launches[k.__name__] <= 0]
    print(f"48x48 fbc 40 B={b} step launches: {launches}")
    if missing:
        raise AssertionError(f"kernels not launched at 48x48 fbc 40: {missing}")


def x2_half_sites(dev, gen):
    """K4b and K14 at the x2-half decoder's up4 sites (models/fast_path.py
    ``mimo_unet_apply_train`` with the flag): the cotangent of the W-half
    upsampled core output [B, H/2, W, C_up] and of its full-res rows
    [B, H, W, C_up], at 256x256 B=64 and 640x480 B=4.  Library: the
    autograd backward of ``F.interpolate`` (bilinear, align_corners) to
    the same size on the channels-last tensor: (H/2, W) from W/2 columns
    for K4b, (H, W) from H/2 rows for K14."""
    import torch
    import torch.nn.functional as Fn
    from mimo_unet_torch import kernels as K

    bf = torch.bfloat16
    c = F * S  # the core's output channels

    def act(*shape):
        return torch.randn(shape, device=dev, generator=gen).to(bf)

    def nchw(t):
        return t.permute(0, 3, 1, 2)

    def interp_backward(x, g):
        xl = nchw(x).detach().requires_grad_()
        out = Fn.interpolate(xl, size=tuple(g.shape[1:3]), mode="bilinear",
                             align_corners=True)
        gl = nchw(g)
        return lambda: torch.autograd.grad(out, xl, gl, retain_graph=True)

    sites = []
    for b, (h, w) in ((BIG_B, PATCH), (TB, NYU)):
        tag = f"{h}x{w} B={b}"
        gh, gw = act(b, h // 2, w, c), act(b, h, w, c)
        half = _nbytes((gh.shape, 2))
        sites.append(Site(
            "upsample_w2x_bwd", f"up4 W-half cotangent {tag} [{b},{h // 2},{w},{c}]",
            lambda gh=gh: K.upsample_w2x_bwd(gh), lambda gh=gh: K.upsample_w2x_bwd_plain(gh),
            True, 5.0 * gh.numel(), 1.5 * half,
            interp_backward(act(b, h // 2, w // 2, c), gh)))
        sites.append(Site(
            "lerp_h2x_transpose", f"up4 H-lerp cotangent {tag} [{b},{h},{w},{c}]",
            lambda gw=gw: K.lerp_h2x_transpose(gw),
            lambda gw=gw: K.lerp_h2x_transpose_plain(gw),
            True, 5.0 * gw.numel(), 3.0 * half,
            interp_backward(act(b, h // 2, w, c), gw)))
    return sites


def x2_half_conv_sites(dev, gen):
    """K5 and K7 with ``x2_half_h`` at dec.c1 (640x480 B=4): against
    their plain versions (phase 3's tolerance), and returns the bitwise
    checks against the full-res form fed K13's output."""
    import torch
    from mimo_unet_torch import kernels as K

    bf = torch.bfloat16
    n, c_up = S * TB, F * S
    mid = (F + c_up) // 2

    def act(*shape, scale=1.0):
        return (torch.randn(shape, device=dev, generator=gen) * scale).to(bf)

    x1s = act(n, TH, TW, F)
    xh = act(TB, TH // 2, TW // 2, c_up)
    half, full = K.upsample_w2x(xh), K.upsample2x(xh)
    w = ((torch.rand((S, 3, 3, F + c_up, mid), device=dev, generator=gen) * 2 - 1)
         / (9 * (F + c_up)) ** 0.5).to(bf).float()
    g = act(n, TH, TW, mid, scale=0.01)
    px = n * TH * TW
    flops = 2.0 * px * 9 * (F + c_up) * mid
    in_bytes = _nbytes((x1s.shape, 2), (half.shape, 2))
    y_bytes = _nbytes(((n, TH, TW, mid), 2))
    w_bytes = _nbytes((w.shape, 2))
    label = f"decoder conv1 (21+42)->31 x2_half_h @{TW}x{TH} B={TB}"
    sites = [
        Site("conv3x3_fwd", label,
             lambda: K.conv3x3_fwd(x1s, w, x2=half, x2_half_h=True),
             lambda: K.conv3x3_fwd_plain(x1s, w, x2=half, x2_half_h=True),
             False, flops, in_bytes + w_bytes + y_bytes),
        Site("conv3x3_dw", label,
             lambda: K.conv3x3_dw(g, x1s, S, x2=half, x2_half_h=True),
             lambda: K.conv3x3_dw_plain(g, x1s, S, x2=half, x2_half_h=True),
             False, flops, in_bytes + y_bytes + _nbytes((w.shape, 4))),
    ]
    same = [("conv3x3_fwd", lambda: K.conv3x3_fwd(x1s, w, x2=half, x2_half_h=True),
             lambda: K.conv3x3_fwd(x1s, w, x2=full)),
            ("conv3x3_dw", lambda: K.conv3x3_dw(g, x1s, S, x2=half, x2_half_h=True),
             lambda: K.conv3x3_dw(g, x1s, S, x2=full))]
    return sites, same


def _objective_run(task, state, dev, image_t, label_t):
    """One forward + backward of the train objective on a copy of the
    state's model: (logits, loss, gradients, running statistics, the
    cotangent of the shared core's output)."""
    import torch
    from mimo_unet_torch.loss_buffer import loss_buffer_init

    model = task.build_model(dev)
    model.load_state_dict(state.model.state_dict())
    model.train()
    core_ct = []

    def keep_cotangent(mod, args, out):
        out.register_hook(lambda g: core_ct.append(g.clone()))

    hook = model.core.register_forward_hook(keep_cotangent)
    loss, _, _, p1, p2 = task.objective(model, image_t, label_t, None,
                                        loss_buffer_init(S, task.loss_buffer_size, dev))
    loss.backward()
    hook.remove()
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()
             if p.grad is not None}
    stats = {k: v.detach().clone() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return (torch.cat([p1, p2], dim=-1).detach(), loss.detach(), grads, stats,
            core_ct[0])


def _x2_half_bitwise(task, state, dev, card):
    """One B=16 256x256 step's forward and backward, flag on against flag
    off (twice), on the same weights and inputs: the logits, the loss, the
    running statistics, the core output's cotangent and the decoder's
    gradients bitwise; every other gradient bitwise or no further from
    the flag-off one than the second flag-off run is."""
    import torch
    from mimo_unet_torch.tasks.mimo import device_normalize
    from mimo_unet_torch.transforms import apply_input_transform

    batch = device_normalize({k: v.to(dev) for k, v in _frames(
        torch.Generator().manual_seed(11), TRAIN_B, PATCH).items()})
    image_t, label_t, _ = apply_input_transform(
        torch.Generator().manual_seed(12), batch["image"], batch["label"], None, S)
    runs = {}
    for name, flag in (("off", "0"), ("on", "1"), ("off again", "0")):
        os.environ[X2_HALF] = flag
        runs[name] = _objective_run(task, state, dev, image_t, label_t)
    os.environ[X2_HALF] = "0"
    (lo, loss_off, g_off, st_off, ct_off), (lh, loss_on, g_on, st_on, ct_on) = (
        runs["off"], runs["on"])
    g_off2 = runs["off again"][2]
    if not torch.equal(ct_on, ct_off):
        raise AssertionError(f"x2-half: the core output's cotangent differs, max abs "
                             f"{float((ct_on - ct_off).abs().max())}")
    if not (torch.equal(lh, lo) and torch.equal(loss_on, loss_off)):
        raise AssertionError(f"x2-half logits or loss differ: max abs "
                             f"{float((lh - lo).abs().max())}, loss {float(loss_on)} vs "
                             f"{float(loss_off)}")
    bad = [k for k in st_off if not torch.equal(st_on[k], st_off[k])]
    if bad:
        raise AssertionError(f"x2-half running statistics differ: {bad}")
    if g_on.keys() != g_off.keys():
        raise AssertionError("x2-half gradient leaves differ")
    same, spread, far = [], [], []
    for k in g_off:
        if torch.equal(g_on[k], g_off[k]):
            same.append(k)
            continue
        if k.startswith("decoder."):
            far.append(k)
            continue
        d_on = float((g_on[k] - g_off[k]).abs().max())
        d_off = float((g_off2[k] - g_off[k]).abs().max())
        spread.append(f"{k} {d_on:.3e} (off runs {d_off:.3e})")
        if d_on > d_off:
            far.append(k)
    print(f"x2-half step 256x256 B={TRAIN_B}: logits, loss {float(loss_on)}, running "
          f"statistics bitwise; {len(same)} of {len(g_off)} gradient leaves bitwise "
          f"({card})")
    for line in spread:
        print(f"  not bitwise: {line}")
    if far:
        raise AssertionError(f"x2-half gradients further from flag-off than the "
                             f"flag-off runs' spread (or a decoder leaf): {far}")


def train_x2_half(dev, card):
    """Phase 13's steps; returns the launch counts of the 256x256 B=64
    steps."""
    import torch
    from mimo_unet_torch import kernels as K

    task = _train_task()
    per_step = {"upsample_w2x": 1, "upsample_w2x_bwd": 1, "lerp_h2x_transpose": 1,
                "upsample2x": 0, "upsample2x_bwd": 0, "max_pool2x2": 2,
                "max_pool2x2_bwd": 2}
    gen = torch.Generator().manual_seed(13)
    states, counts = {}, {}
    os.environ[X2_HALF] = "1"
    for b, hw in ((BIG_B, PATCH), (TRAIN_B, NYU)):
        state = task.init_state(-(-795 // b), dev)
        batches = [_frames(gen, b, hw) for _ in range(3)]
        torch.cuda.synchronize()
        K.reset_launch_counts()
        for batch in batches:
            state, logs, _ = task.train_step(state, batch)
            if not torch.isfinite(logs["train_loss"]):
                raise AssertionError(f"x2-half {hw} step: non-finite loss")
        torch.cuda.synchronize()
        launches = K.launch_counts()
        print(f"x2-half {hw[0]}x{hw[1]} B={b} 3 steps: launches {launches}")
        missing = [k.__name__ for k in K.TRAIN_KERNELS if launches[k.__name__] <= 0]
        wrong = {k: launches[k] for k, v in per_step.items() if launches[k] != 3 * v}
        if missing or wrong:
            raise AssertionError(f"x2-half {hw} launches: missing {missing}, counts "
                                 f"{wrong} (want {per_step} per step)")
        if not all(bool(torch.isfinite(p).all()) for p in state.model.parameters()):
            raise AssertionError(f"non-finite parameters after 3 x2-half {hw} steps")
        states[hw], counts[hw] = state, launches
    # deterministic algorithms for the comparison: the plain core's
    # backward (cuDNN, atomics) otherwise differs from run to run
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _x2_half_bitwise(task, states[PATCH], dev, card)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()

    os.environ[X2_HALF] = "1"
    _profile_step(task, states[PATCH], _frames(gen, BIG_B, PATCH), card,
                  f"x2-half 256x256 B={BIG_B}")
    for b, hw in ((BIG_B, PATCH), (TRAIN_B, NYU)):
        for flag in ("1", "0", "0", "1"):
            os.environ[X2_HALF] = flag
            _time_steps(task, states[hw], gen, b, 3, card,
                        f"x2-half {'on' if flag == '1' else 'off'}", hw)
        torch.cuda.empty_cache()
    os.environ[X2_HALF] = "0"
    return counts[PATCH]


@contextlib.contextmanager
def record_groups(names):
    """Record the groups argument (the last before the stream) of every
    launch of the library entries ``names``: {name: set of groups}."""
    from mimo_unet_torch.kernels import _build

    seen = {n: set() for n in names}
    launch = _build.launch

    def recording(name, device, *args):
        if name in seen:
            seen[name].add(int(args[-1]))
        return launch(name, device, *args)

    _build.launch = recording
    try:
        yield seen
    finally:
        _build.launch = launch


def train_mc(dev, card):
    """Phase 9; returns the launch counts of the MC-recipe steps and of the
    final-dropout step."""
    import torch
    from mimo_unet_torch import kernels as K

    task = _train_task(**MC_RECIPE)
    spe = -(-795 // TRAIN_B)
    state = task.init_state(spe, dev)
    _grad_check(task, state, dev, card, min_cos=0.999, f32_ref=True)
    torch.cuda.empty_cache()

    gen = torch.Generator().manual_seed(9)
    batches = [_frames(gen, TRAIN_B) for _ in range(3)]
    per_image = ("mimo_affine_relu", "mimo_affine_relu_bwd", "mimo_conv1x1_prelu",
                 "mimo_conv1x1_prelu_bwd")
    torch.cuda.synchronize()
    K.reset_launch_counts()
    with record_groups(per_image) as groups:
        for i, batch in enumerate(batches):
            state, logs, _ = task.train_step(state, batch)
            loss = float(logs["train_loss"])
            print(f"MC-recipe train step {i}: loss {loss:.5f}")
            if not torch.isfinite(torch.tensor(loss)):
                raise AssertionError(f"MC step {i}: non-finite loss")
        torch.cuda.synchronize()
    launches = K.launch_counts()
    print(f"MC-recipe train launches: {launches}; K8/K12 groups: {groups}")
    missing = [k.__name__ for k in K.TRAIN_KERNELS + K.RESAMPLE_KERNELS
               if launches[k.__name__] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the MC train path: {missing}")
    not_per_image = [k for k, g in groups.items() if S * TRAIN_B not in g]
    if not_per_image:
        raise AssertionError(f"no launch at groups = N: {not_per_image}")
    if not all(bool(torch.isfinite(p).all()) for p in state.model.parameters()):
        raise AssertionError("non-finite parameters after 3 MC-recipe steps")
    _time_steps(task, state, gen, TRAIN_B, 5, card, "MC recipe, kernels")
    del state
    plain = dataclasses.replace(task, ct_kernels="off")
    pstate = plain.init_state(spe, dev)
    _time_steps(plain, pstate, gen, TRAIN_B, 5, card, "MC recipe, plain (cuDNN bf16)")
    del pstate
    torch.cuda.empty_cache()

    # the final-dropout route: K8, the elementwise dropout, K11 fwd + bwd
    ftask = dataclasses.replace(task, final_dropout_rate=0.1,
                                **{k: 0.0 for k in MC_RECIPE})
    fstate = ftask.init_state(spe, dev)
    batch = _frames(gen, TB)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    fstate, logs, _ = ftask.train_step(fstate, batch)
    torch.cuda.synchronize()
    flaunch = K.launch_counts()
    print(f"final-dropout step B={TB}: loss {float(logs['train_loss']):.5f}, "
          f"launches {flaunch}")
    missing = [k.__name__ for k in (K.conv1x1, K.conv1x1_bwd, K.affine_relu,
                                    K.affine_relu_bwd) if flaunch[k.__name__] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the final-dropout route: {missing}")
    _grad_check(ftask, fstate, dev, card, b=TB, min_cos=0.999, f32_ref=True)
    return launches, flaunch


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

    # ---- 3-12 ---------------------------------------------------------------
    os.environ[X2_HALF] = "0"  # the default decoder until phase 13
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
    torch.cuda.empty_cache()
    stats.update(check_kernels(
        dropout_kernel_sites(dev, torch.Generator(device=dev).manual_seed(2)), card))
    torch.cuda.empty_cache()
    served_mc = serve_mc(dev, card)
    torch.cuda.empty_cache()
    trained_mc, final = train_mc(dev, card)
    torch.cuda.empty_cache()
    stats.update(check_kernels(
        resample_sites(dev, torch.Generator(device=dev).manual_seed(3)), card))
    torch.cuda.empty_cache()
    patch = train_patch(dev, card)
    torch.cuda.empty_cache()
    train_tail(dev, card)
    torch.cuda.empty_cache()

    # ---- 13. the x2-half train decoder ---------------------------------------
    stats.update(check_kernels(
        x2_half_sites(dev, torch.Generator(device=dev).manual_seed(5)), card))
    torch.cuda.empty_cache()
    half_sites, same = x2_half_conv_sites(dev, torch.Generator(device=dev).manual_seed(6))
    check_kernels(half_sites, card)  # times of these sites: printed, not summed
    for name, half, full in same:
        compare(f"{name} x2_half_h vs fed K13's output", half(), full(), True)
        print(f"{name} x2_half_h: bitwise its full-res form fed K13's output")
    del half_sites, same
    torch.cuda.empty_cache()
    halfed = train_x2_half(dev, card)
    launches = {k.__name__: served[k.__name__] for k in K.EVAL_KERNELS}
    launches.update({k.__name__: trained[k.__name__] for k in K.TRAIN_KERNELS})
    launches["conv1x1"] = served_mc["conv1x1"]
    launches["conv1x1_bwd"] = final["conv1x1_bwd"]
    launches.update({k.__name__: patch[k.__name__] for k in K.RESAMPLE_KERNELS})
    launches.update({k.__name__: halfed[k.__name__] for k in K.X2_HALF_KERNELS})

    # ---- 14. results -------------------------------------------------------
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
