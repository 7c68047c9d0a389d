"""Plain PyTorch MIMO U-Net: the benchmark's reference of the architecture.

A frozen, independent statement of the model that ``mimo_unet_torch``
serves and trains (antonbaumann/MIMO-Unet, mimo/models/mimo_components/
model.py and components.py): S per-subnetwork encoders (in_conv, down1)
and decoders (up4, out-conv) around one shared core (down2 .. up3) that
sees the subnetworks' channels concatenated.  Every DoubleConv is
(3x3 reflect conv -> BatchNorm -> ReLU) x 2; Down is a 2x2 max pool then
a DoubleConv; Up is a bilinear x2 upsample (align_corners), a zero pad to
the skip, the concat [skip, upsampled], then a DoubleConv whose middle
width is half its input's.

Parameters live in a plain dict keyed by the reference's state-dict keys,
so the benchmark hands the same weights to the program with
``load_state_dict``.  Activations are NCHW float32; ``quant`` rounds what a
lower-precision program would store: each convolution's input, weight and
output and each BatchNorm's output (the identity for the reference, fp8 for
its control, ``reference/quant.py``).  ``remat`` recomputes each section
(encoder, core, decoder of a subnetwork) in the backward, so a training
step at the cell's own batch fits on one card; BatchNorm's batch
statistics are always those of the whole batch.

Nothing here imports the program.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Params = Dict[str, torch.Tensor]
Quant = Callable[[torch.Tensor], torch.Tensor]
BN_EPS = 1e-5


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def double_convs(cfg: dict) -> List[Tuple[str, int, int, int]]:
    """Every DoubleConv as (key prefix, in, mid, out) channels."""
    f, s, cin = cfg["filter_base_count"], cfg["num_subnetworks"], cfg["in_channels"]
    fs = f * s
    blocks = []
    for i in range(s):
        blocks.append((f"encoder.in_convs.{i}", cin, f, f))
        blocks.append((f"encoder.down1s.{i}.conv", f, 2 * f, 2 * f))
    blocks += [
        ("core.down2.conv", 2 * fs, 4 * fs, 4 * fs),
        ("core.down3.conv", 4 * fs, 8 * fs, 8 * fs),
        ("core.down4.conv", 8 * fs, 8 * fs, 8 * fs),
        ("core.up1.conv", 16 * fs, 8 * fs, 4 * fs),
        ("core.up2.conv", 8 * fs, 4 * fs, 2 * fs),
        ("core.up3.conv", 4 * fs, 2 * fs, fs),
    ]
    for i in range(s):
        blocks.append((f"decoder.up4s.{i}.conv", fs + f, (fs + f) // 2, f))
    return blocks


def tensor_shapes(cfg: dict) -> Dict[str, Tuple[str, Tuple[int, ...]]]:
    """Every state-dict entry: key -> (kind, shape), kind one of conv_w,
    conv_b (with the conv's fan-in last in the shape's reading), bn_w,
    bn_b, bn_mean, bn_var, bn_count."""
    out = {}
    for pre, cin, mid, cout in double_convs(cfg):
        for conv, bn, ci, co in (("0", "1", cin, mid), ("3", "4", mid, cout)):
            out[f"{pre}.double_conv.{conv}.weight"] = ("conv_w", (co, ci, 3, 3))
            out[f"{pre}.double_conv.{conv}.bias"] = ("conv_b", (co,))
            out[f"{pre}.double_conv.{bn}.weight"] = ("bn_w", (co,))
            out[f"{pre}.double_conv.{bn}.bias"] = ("bn_b", (co,))
            out[f"{pre}.double_conv.{bn}.running_mean"] = ("bn_mean", (co,))
            out[f"{pre}.double_conv.{bn}.running_var"] = ("bn_var", (co,))
            out[f"{pre}.double_conv.{bn}.num_batches_tracked"] = ("bn_count", ())
    f, oc = cfg["filter_base_count"], cfg["out_channels"]
    for i in range(cfg["num_subnetworks"]):
        out[f"decoder.outcs.{i}.conv.weight"] = ("conv_w", (oc, f, 1, 1))
        out[f"decoder.outcs.{i}.conv.bias"] = ("conv_b", (oc,))
    return out


def parameter_keys(cfg: dict) -> List[str]:
    """The trainable entries (what the optimizer updates), in order."""
    return [k for k, (kind, _) in tensor_shapes(cfg).items()
            if kind in ("conv_w", "conv_b", "bn_w", "bn_b")]


def count_parameters(cfg: dict) -> int:
    shapes = tensor_shapes(cfg)
    total = 0
    for k in parameter_keys(cfg):
        n = 1
        for d in shapes[k][1]:
            n *= d
        total += n
    return total


def _conv3x3(x, p, key, quant):
    x = F.pad(x, (1, 1, 1, 1), mode="reflect")
    return quant(F.conv2d(quant(x), quant(p[key + ".weight"]), p[key + ".bias"]))


def _bn(x, p, key, train):
    if isinstance(train, float):
        # set the running statistics from this batch (the variance times
        # ``train``), then normalise by them as eval mode does
        p[key + ".running_mean"].copy_(x.mean(dim=(0, 2, 3)))
        p[key + ".running_var"].copy_(x.var(dim=(0, 2, 3)) * train)
        train = False
    if train:
        return F.batch_norm(x, None, None, p[key + ".weight"], p[key + ".bias"],
                            training=True, eps=BN_EPS)
    return F.batch_norm(x, p[key + ".running_mean"], p[key + ".running_var"],
                        p[key + ".weight"], p[key + ".bias"], training=False,
                        eps=BN_EPS)


def double_conv(x, p, pre, train, quant):
    y = torch.relu(quant(_bn(_conv3x3(x, p, pre + ".double_conv.0", quant), p,
                             pre + ".double_conv.1", train)))
    return torch.relu(quant(_bn(_conv3x3(y, p, pre + ".double_conv.3", quant), p,
                                pre + ".double_conv.4", train)))


def up(x1, skip, p, pre, train, quant):
    x1 = F.interpolate(x1, scale_factor=2, mode="bilinear", align_corners=True)
    dy, dx = skip.shape[-2] - x1.shape[-2], skip.shape[-1] - x1.shape[-1]
    x1 = F.pad(x1, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))
    return double_conv(torch.cat([skip, x1], dim=1), p, pre, train, quant)


def forward(p: Params, x: torch.Tensor, cfg: dict, *, train,
            quant: Quant = identity, remat: bool = False) -> torch.Tensor:
    """x [B, S, H, W, C_in] float32 -> [B, S, H, W, C_out] float32: input
    s feeds subnetwork s.  Train mode (``train`` True): BatchNorm by batch
    statistics, the running ones left alone (nothing here reads them).
    Eval mode (False): BatchNorm by the running ones.  A float ``train``
    first sets each running mean to its input's batch mean and each running
    variance to the batch variance times that float, layer by layer, then
    normalises by them."""
    s = cfg["num_subnetworks"]

    def section(fn, *args):
        if remat:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def encoder(xi, i):
        x1 = double_conv(xi, p, f"encoder.in_convs.{i}", train, quant)
        x2 = double_conv(F.max_pool2d(x1, 2), p, f"encoder.down1s.{i}.conv",
                         train, quant)
        return x1, x2

    def core(xc):
        x3 = double_conv(F.max_pool2d(xc, 2), p, "core.down2.conv", train, quant)
        x4 = double_conv(F.max_pool2d(x3, 2), p, "core.down3.conv", train, quant)
        x5 = double_conv(F.max_pool2d(x4, 2), p, "core.down4.conv", train, quant)
        u = up(x5, x4, p, "core.up1.conv", train, quant)
        u = up(u, x3, p, "core.up2.conv", train, quant)
        return up(u, xc, p, "core.up3.conv", train, quant)

    def decoder(xu, x1, i):
        y = up(xu, x1, p, f"decoder.up4s.{i}.conv", train, quant)
        key = f"decoder.outcs.{i}.conv"
        return quant(F.conv2d(quant(y), quant(p[key + ".weight"]), p[key + ".bias"]))

    xs = x.permute(0, 1, 4, 2, 3)
    enc = [section(encoder, xs[:, i], i) for i in range(s)]
    xu = section(core, torch.cat([e[1] for e in enc], dim=1))
    logits = [section(decoder, xu, enc[i][0], i) for i in range(s)]
    return torch.stack(logits, dim=1).permute(0, 1, 3, 4, 2)
