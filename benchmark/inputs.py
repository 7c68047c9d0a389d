"""Inputs made from ``--seed``: weights and synthetic frames of the NYUv2
schema (uint8 image [H, W, 3] and depth [H, W, 1], 1.2288 MB a 640x480
frame).  Everything is drawn on the run's device by ``torch.Generator``s
in a few large calls, so one seed gives one set of inputs there.

Frames are synthetic, not NYUv2: each has its own brightness, contrast,
depth level and depth slope, plus per-pixel noise, so that which frames a
batch holds moves its loss (a step that drops part of its batch shows).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference import model as ref_model

_MASK64 = (1 << 64) - 1


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one stream of inputs (splitmix64 of the pair)."""
    x = (seed * 0x9E3779B97F4A7C15 + stream * 0xD1B54A32D192ED03 + 1) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) >> 1


WEIGHTS, FRAMES, ORDER, SAMPLE, CALIBRATION = range(5)
CALIBRATION_FRAMES = 4


def frames(seed: int, n: int, h: int, w: int, device, chunk: int = 32
           ) -> Dict[str, torch.Tensor]:
    """n synthetic uint8 frames: image [n, h, w, 3], label [n, h, w, 1]."""
    g = torch.Generator(device).manual_seed(sub_seed(seed, FRAMES))
    per = torch.rand(n, 8, generator=g, device=device)
    image = torch.empty(n, h, w, 3, dtype=torch.uint8, device=device)
    label = torch.empty(n, h, w, 1, dtype=torch.uint8, device=device)
    ramp = torch.linspace(-1.0, 1.0, w, device=device).view(1, 1, w, 1)
    for a in range(0, n, chunk):
        q = per[a:a + chunk].view(-1, 1, 1, 8)
        k = q.shape[0]
        base = 20 + 200 * q[..., 0:3]
        amp = 5 + 40 * q[..., 3:4]
        noise = torch.rand(k, h, w, 4, generator=g, device=device) * 2 - 1
        image[a:a + k] = (base + amp * noise[..., :3]).clamp(0, 255).to(torch.uint8)
        depth = (20 + 215 * q[..., 4:5] + 60 * (q[..., 5:6] - 0.5) * ramp
                 + (2 + 13 * q[..., 6:7]) * noise[..., 3:4])
        label[a:a + k] = depth.clamp(0, 255).to(torch.uint8)
    return {"image": image, "label": label}


# the served model's out-convs are scaled by this, so that its log-scale
# output log_b stays O(1), as a trained model's does: unscaled, log_b reads
# up to +-7 and the aleatoric variance 2 b^2 spans eight decades
OUT_SCALE = 0.1


def weights(cfg: dict, seed: int, device, *, serving: bool) -> Dict[str, torch.Tensor]:
    """A state dict of the reference's keys, drawn in one call: convs
    U(-1/sqrt(fan_in), +) as torch initialises them, BatchNorm at torch's
    defaults.  For serving the out-convs' weights are scaled by
    ``OUT_SCALE`` (``serving_weights`` then sets the running statistics)."""
    shapes = ref_model.tensor_shapes(cfg)
    sizes = [math.prod(shape) for _, shape in shapes.values()]
    g = torch.Generator(device).manual_seed(sub_seed(seed, WEIGHTS))
    u = torch.rand(sum(sizes), generator=g, device=device) * 2 - 1
    out, at = {}, 0
    for (key, (kind, shape)), size in zip(shapes.items(), sizes):
        r = u[at:at + size].view(shape)
        at += size
        if kind in ("conv_w", "conv_b"):
            ws = shapes[key.rsplit(".", 1)[0] + ".weight"][1]
            out[key] = r / math.sqrt(ws[1] * ws[2] * ws[3])
            if serving and kind == "conv_w" and key.startswith("decoder.outcs."):
                out[key] = out[key] * OUT_SCALE
        elif kind == "bn_count":
            out[key] = torch.zeros((), dtype=torch.long, device=device)
        else:
            out[key] = torch.ones_like(r) if kind in ("bn_w", "bn_var") else torch.zeros_like(r)
    return out


def set_statistics(p: Dict[str, torch.Tensor], cfg: dict, seed: int, device, h: int, w: int
                   ) -> None:
    """Set every BatchNorm's running statistics in ``p`` to those of its
    input over a few seeded frames at the served size, taken by the
    reference in float32, layer by layer: the statistics a trained model
    holds, so each layer sees normalised inputs."""
    image = frames(sub_seed(seed, CALIBRATION), CALIBRATION_FRAMES, h, w, device)["image"]
    x = (image.float() / 255.0).unsqueeze(1).expand(-1, cfg["num_subnetworks"], -1, -1, -1)
    with torch.no_grad():
        ref_model.forward(p, x, cfg, train=1.0)


def serving_weights(cfg: dict, seed: int, device, h: int, w: int) -> Dict[str, torch.Tensor]:
    """``weights(serving=True)`` with the running statistics set."""
    p = weights(cfg, seed, device, serving=True)
    set_statistics(p, cfg, seed, device, h, w)
    return p
