"""The arithmetic the per-layer metrics divide by, frozen with the benchmark.

* ``PEAKS``: the card's published dense peaks (NVIDIA H100 SXM data sheet):
  989 TFLOP/s in bf16 and 3.35 TB/s of HBM, at its 700 W limit.
* ``model_flops``: model FLOPs of one image of a train step (forward and
  backward, no recomputation) or of one served frame, counted by
  ``FlopCounterMode`` over the benchmark's own reference at a small size
  and scaled by pixels (a 3x3 reflect conv's work is linear in them).
* ``train_conv_sites`` / ``eval_conv_sites``: the call sites of the train
  conv kernels (K5 forward, K6 dx, K7 dw) and of the fused eval DoubleConv
  (K1/K2), each with the least work it needs: its FLOPs, and its bf16
  inputs read once and outputs written once.  A site's bound is
  max(FLOPs / peak, bytes / bandwidth).
"""

from __future__ import annotations

import functools
import json
from typing import Dict, List

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import model as ref_model, train as ref_train

PEAKS = {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}
BF16 = 2
SMALL = (64, 96)  # (H, W) of the count: every level of the U-Net even


def _key(cfg: dict) -> str:
    return json.dumps({k: cfg[k] for k in ("in_channels", "out_channels",
                                           "num_subnetworks", "filter_base_count")},
                      sort_keys=True)


@functools.lru_cache(maxsize=None)
def _flops_small(key: str, kind: str, h: int, w: int) -> int:
    cfg = json.loads(key)
    s, cin = cfg["num_subnetworks"], cfg["in_channels"]
    g = torch.Generator().manual_seed(0)
    shapes = ref_model.tensor_shapes(cfg)
    p = {k: torch.rand(shape, generator=g) + (1.0 if kind_ == "bn_var" else 0.0)
         for k, (kind_, shape) in shapes.items() if kind_ != "bn_count"}
    x = torch.rand(1, s, h, w, cin, generator=g)
    counter = FlopCounterMode(display=False)
    if kind == "serve":
        with torch.no_grad(), counter:
            ref_model.forward(p, x, cfg, train=False)
    else:
        leaves = [p[k].requires_grad_(True) for k in ref_model.parameter_keys(cfg)]
        c = cfg["out_channels"] // 2
        with counter:
            out = ref_model.forward(p, x, cfg, train=True)
            loss = ref_train.laplace_nll(out[..., :c], out[..., c:],
                                         torch.rand(1, s, h, w, c, generator=g)).mean()
            torch.autograd.grad(loss, leaves)
    return counter.get_total_flops()


def model_flops(cfg: dict, kind: str, h: int, w: int, small=SMALL) -> float:
    """FLOPs of one image at h x w: ``kind`` "train" (a step's forward and
    backward) or "serve" (one forward)."""
    return _flops_small(_key(cfg), kind, *small) * (h * w) / (small[0] * small[1])


def _conv(name, kernel, n, h, w, cin, cout, inputs, outputs, weights) -> Dict[str, float]:
    return {"site": name, "kernel": kernel,
            "flops": 2.0 * 9 * cin * cout * n * h * w,
            "bytes": float(BF16 * (inputs + outputs) + 4 * weights)}


def train_conv_sites(cfg: dict, b: int, h: int, w: int) -> List[Dict[str, float]]:
    """K5 / K6 / K7 at every train-route conv of one step.  Subnetworks fold
    into the image axis (n = S*B), each with its own weights; the decoder's
    conv1 reads [x1 (F), the upsampled core output (FS, shared by the S
    subnetworks)].  The in_conv's first conv has no dx (its input needs no
    gradient)."""
    f, s, cin = cfg["filter_base_count"], cfg["num_subnetworks"], cfg["in_channels"]
    fs, n = f * s, s * b
    mid = (fs + f) // 2
    hw, qw = h * w, (h // 2) * (w // 2)
    convs = [  # name, pixels a image, in, out, input elems, dx
        ("in.c1", h, w, cin, f, n * hw * cin, False),
        ("in.c2", h, w, f, f, n * hw * f, True),
        ("down1.c1", h // 2, w // 2, f, 2 * f, n * qw * f, True),
        ("down1.c2", h // 2, w // 2, 2 * f, 2 * f, n * qw * 2 * f, True),
        ("dec.c1", h, w, f + fs, mid, n * hw * f + b * hw * fs, True),
        ("dec.c2", h, w, mid, f, n * hw * mid, True),
    ]
    sites = []
    for name, hh, ww, ci, co, x_elems, dx in convs:
        y_elems = n * hh * ww * co
        wts = s * 9 * ci * co
        sites.append(_conv(name, "K5", n, hh, ww, ci, co, x_elems, y_elems, wts))
        if dx:
            sites.append(_conv(name, "K6", n, hh, ww, ci, co, y_elems, x_elems, wts))
        sites.append(_conv(name, "K7", n, hh, ww, ci, co, x_elems + y_elems, 0, 2 * wts))
    return sites


def eval_conv_sites(cfg: dict, b: int, h: int, w: int) -> List[Dict[str, float]]:
    """K1 / K2 at the eval route's four fused DoubleConvs of one forward:
    in_conv (K2), down1, up3 and the decoder's up4 with the 1x1 out-conv
    (K1).  The up3 and decoder kernels read their upsampled input at half
    height (the H lerp is in-kernel); in_conv and down1 also write the H
    half of the next pool."""
    f, s, cin = cfg["filter_base_count"], cfg["num_subnetworks"], cfg["in_channels"]
    oc = cfg["out_channels"]
    fs, n = f * s, s * b
    h2, w2, h4 = h // 2, w // 2, h // 4
    mid = (fs + f) // 2

    def site(name, kernel, n_, hh, ww, c0, c1, c2, in_elems, out_elems, extra_flops=0.0,
             extra_w=0):
        flops = 2.0 * 9 * (c0 * c1 + c1 * c2) * n_ * hh * ww + extra_flops
        wts = (s if n_ == n else 1) * 9 * (c0 * c1 + c1 * c2) + extra_w
        return {"site": name, "kernel": kernel, "flops": flops,
                "bytes": float(BF16 * (in_elems + out_elems + wts))}

    return [
        site("in_conv", "K2", n, h, w, cin, f, f, b * h * w * cin,
             n * h * w * f + n * h2 * w * f),
        site("down1", "K1", n, h2, w2, f, 2 * f, 2 * f, n * h2 * w2 * f,
             b * h2 * w2 * 2 * fs + b * h4 * w2 * 2 * fs),
        site("up3", "K1", b, h2, w2, 4 * fs, 2 * fs, fs,
             b * h2 * w2 * 2 * fs + b * h4 * w2 * 2 * fs, b * h2 * w2 * fs),
        site("decoder", "K1", n, h, w, f + fs, mid, f,
             n * h * w * f + b * h2 * w * fs, n * h * w * oc,
             extra_flops=2.0 * f * oc * n * h * w, extra_w=s * f * oc),
    ]


def bound_seconds(sites: List[Dict[str, float]]) -> float:
    return sum(max(x["flops"] / PEAKS["bf16_flops"], x["bytes"] / PEAKS["hbm_bytes_per_s"])
               for x in sites)
