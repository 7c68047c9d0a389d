"""Plain PyTorch MC-dropout serving of the MIMO U-Net: the reference of the
cells that serve with ``monte_carlo_steps`` passes.

The architecture is ``reference/model.py``'s with the reference repo's
Dropout2d after every DoubleConv (antonbaumann/MIMO-Unet, Readme.md:82, on
the recipe of Readme.md:61-79; mimo/models/mimo_components/components.py:29):
the encoder's in_conv and down1 at ``encoder_dropout_rate``, the core's
down2 .. up3 at ``core_dropout_rate``, the decoder's up4 at
``decoder_dropout_rate``.  A live site multiplies its DoubleConv's output
by a [B, C] keep mask over the keep probability, ``x * mask / keep``, one
mask element per (image, channel).  Serving (mimo/models/ensemble.py:35-115)
keeps BatchNorm in eval mode with the dropout sites live, runs T passes
and decomposes over the S * T predictions: mean, aleatoric = the mean of
the per-prediction variances 2 b^2, epistemic = the unbiased variance of
the predictions' means (``train.uncertainties``).

The masks follow the program's documented contract, so the reference
applies the masks the program drew:

* a ``predict`` call folds each batch's start into its seed and each
  member's index into that, ``fold_in(fold_in(seed, start), member)``
  (splitmix64's finaliser of the pair, ``fold_in`` below);
* one ``torch.Generator`` on the serving device is seeded with it;
* the T passes are folded pass-major into one batch (row j * B + b is pass
  j of frame b), and each live site draws one ``torch.rand([T * B, C]) <
  keep`` from that generator, in the order of ``sites``.

Departures from the reference repo, none of which changes the function
served: the masks come from that seeded generator, not from torch's global
RNG through ``nn.Dropout2d``; the T passes are one folded batch, not T
forward calls (BatchNorm in eval mode makes every row independent); the
prediction axis is pass-major (column j * S + s is pass j of subnetwork
s), an order the decomposition does not see.  Activations are float32 with
TF32 off (the caller's ``no_tf32``); ``quant`` rounds what a lower-precision
program stores, as in ``model.py``, the dropout's output included.

Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import model as ref_model, train as ref_train

Masks = Dict[str, Tuple[torch.Tensor, float]]
_MASK64 = (1 << 64) - 1


def fold_in(seed: int, data: int) -> int:
    """A 63-bit seed from (seed, data): splitmix64's finaliser of
    ``seed * golden + data + 0x632BE59BD9B4E019``."""
    x = (seed * 0x9E3779B97F4A7C15 + data + 0x632BE59BD9B4E019) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) >> 1


def sites(cfg: dict) -> Dict[str, Tuple[int, float]]:
    """Every live Dropout2d site of the bilinear model, in draw order:
    name -> (channels, rate).  Per subnetwork the encoder's in_conv and
    down1, then the core's six DoubleConvs, then per subnetwork the
    decoder's up4."""
    f, s = cfg["filter_base_count"], cfg["num_subnetworks"]
    fs = f * s
    enc, core, dec = (cfg["task"][k] for k in ("encoder_dropout_rate", "core_dropout_rate",
                                                "decoder_dropout_rate"))
    out = {}
    for i in range(s):
        out[f"encoder.{i}.in_conv"] = (f, enc)
        out[f"encoder.{i}.down1"] = (2 * f, enc)
    for name, c in (("down2", 4 * fs), ("down3", 8 * fs), ("down4", 8 * fs),
                    ("up1", 4 * fs), ("up2", 2 * fs), ("up3", fs)):
        out[f"core.{name}"] = (c, core)
    for i in range(s):
        out[f"decoder.{i}.up4"] = (f, dec)
    return {k: v for k, v in out.items() if v[1] > 0}


def draw_masks(cfg: dict, rows: int, seed: int, device) -> Masks:
    """The keep masks of one member's forward over ``rows`` folded images
    (T passes of a batch), from a generator seeded with ``seed`` (the
    member's ``fold_in(fold_in(call seed, batch start), member)``)."""
    g = torch.Generator(device).manual_seed(seed)
    return {name: (torch.rand((rows, c), generator=g, device=device) < 1.0 - rate, 1.0 - rate)
            for name, (c, rate) in sites(cfg).items()}


def dead_masks(masks: Masks) -> Masks:
    """Every element kept: the sites scale by 1 / keep and drop nothing."""
    return {k: (torch.ones_like(m), keep) for k, (m, keep) in masks.items()}


def forward(p, x: torch.Tensor, cfg: dict, masks: Masks,
            quant=ref_model.identity) -> torch.Tensor:
    """Eval forward with live Dropout2d sites: x [N, S, H, W, C_in] float32,
    masks name -> ([N, C] bool, keep) -> [N, S, H, W, C_out]."""
    s = cfg["num_subnetworks"]

    def dc(xi, pre, site):
        y = ref_model.double_conv(xi, p, pre, False, quant)
        if site not in masks:
            return y
        mask, keep = masks[site]
        return quant(y * mask[:, :, None, None].to(y.dtype) / keep)

    def up(x1, skip, pre, site):
        x1 = F.interpolate(x1, scale_factor=2, mode="bilinear", align_corners=True)
        dy, dx = skip.shape[-2] - x1.shape[-2], skip.shape[-1] - x1.shape[-1]
        x1 = F.pad(x1, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))
        return dc(torch.cat([skip, x1], dim=1), pre, site)

    xs = x.permute(0, 1, 4, 2, 3)
    x1s, x2s = [], []
    for i in range(s):
        x1s.append(dc(xs[:, i], f"encoder.in_convs.{i}", f"encoder.{i}.in_conv"))
        x2s.append(dc(F.max_pool2d(x1s[i], 2), f"encoder.down1s.{i}.conv",
                      f"encoder.{i}.down1"))
    xc = torch.cat(x2s, dim=1)
    x3 = dc(F.max_pool2d(xc, 2), "core.down2.conv", "core.down2")
    x4 = dc(F.max_pool2d(x3, 2), "core.down3.conv", "core.down3")
    x5 = dc(F.max_pool2d(x4, 2), "core.down4.conv", "core.down4")
    u = up(x5, x4, "core.up1.conv", "core.up1")
    u = up(u, x3, "core.up2.conv", "core.up2")
    xu = up(u, xc, "core.up3.conv", "core.up3")
    logits = []
    for i in range(s):
        y = up(xu, x1s[i], f"decoder.up4s.{i}.conv", f"decoder.{i}.up4")
        key = f"decoder.outcs.{i}.conv"
        logits.append(quant(F.conv2d(quant(y), quant(p[key + ".weight"]), p[key + ".bias"])))
    return torch.stack(logits, dim=1).permute(0, 1, 3, 4, 2)


def serve(p, images: torch.Tensor, cfg: dict, masks: Masks, passes: int, batch: int,
          rows: Sequence[int], quant=ref_model.identity):
    """float32 frames ``images`` [k, H, W, C], rows ``rows`` of a batch of
    ``batch`` frames whose masks over ``passes`` folded passes are
    ``masks`` -> (mean, aleatoric, epistemic) [k, H, W, C_out / 2]."""
    k, s = images.shape[0], cfg["num_subnetworks"]
    idx = torch.tensor([j * batch + r for j in range(passes) for r in rows],
                       device=images.device)
    block = {n: (m[idx], keep) for n, (m, keep) in masks.items()}
    x = images.unsqueeze(1).expand(-1, s, -1, -1, -1).repeat(passes, 1, 1, 1, 1)
    out = forward(p, x, cfg, block, quant=quant)
    # [T * k, S, ...] pass-major -> [k, T * S, ...]: column j * S + s
    out = out.reshape(passes, k, *out.shape[1:]).transpose(0, 1).reshape(k, passes * s,
                                                                          *out.shape[2:])
    c = cfg["out_channels"] // 2
    return ref_train.uncertainties(out[..., :c], out[..., c:])
