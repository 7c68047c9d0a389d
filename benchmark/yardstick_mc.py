"""The arithmetic of the MC-dropout serving cells' per-layer metrics, beside
``yardstick.py`` (whose peaks and FLOP count it uses).

* ``mc_eval_conv_sites``: K1 / K2 at the four fused DoubleConvs of one MC
  forward, whose batch is the T passes folded pass-major (n = S * B * T
  subnetwork images).  in_conv, down1 and up3 are ``yardstick``'s sites at
  that batch; the decoder's DoubleConv writes its F channels, since a live
  up4 site sits between it and the out-conv, which runs apart (K11).
* ``mc_outconv_sites``: K11, the grouped 1x1 out-conv of that forward:
  the decoder's output read once in bf16, the logits written once, the
  weights (bf16) and bias (f32) read once.
A site's bound is max(FLOPs / peak, bytes / bandwidth), ``yardstick.bound_seconds``.
"""

from __future__ import annotations

from typing import Dict, List

from benchmark import yardstick

BF16, F32 = 2, 4


def mc_eval_conv_sites(cfg: dict, b: int, passes: int, h: int, w: int
                       ) -> List[Dict[str, float]]:
    """K1 / K2 of one forward of ``b`` frames at ``passes`` MC passes."""
    f, s = cfg["filter_base_count"], cfg["num_subnetworks"]
    fs, bt = f * s, b * passes
    n, mid = s * bt, (fs + f) // 2
    sites = [x for x in yardstick.eval_conv_sites(cfg, bt, h, w) if x["site"] != "decoder"]
    # up4 over [x1s (F), the W-upsampled up3 output at half height (FS, shared
    # by the S subnetworks)], F channels out and no out-conv
    convs = (f + fs) * mid + mid * f
    in_elems = n * h * w * f + bt * (h // 2) * w * fs
    sites.append({"site": "decoder", "kernel": "K1", "flops": 2.0 * 9 * convs * n * h * w,
                  "bytes": float(BF16 * (in_elems + n * h * w * f + s * 9 * convs))})
    return sites


def mc_outconv_sites(cfg: dict, b: int, passes: int, h: int, w: int
                     ) -> List[Dict[str, float]]:
    """K11 of one forward of ``b`` frames at ``passes`` MC passes."""
    f, s, oc = cfg["filter_base_count"], cfg["num_subnetworks"], cfg["out_channels"]
    px = s * b * passes * h * w
    return [{"site": "outc", "kernel": "K11", "flops": 2.0 * f * oc * px,
             "bytes": float(BF16 * (px * f + px * oc + s * f * oc) + F32 * s * oc)}]

