"""Weight transplant from the JAX package's pytrees into the port.

``jax_pytree_to_state_dict`` is the exact inverse of
``mimo_unet_tpu/interop.py`` ``torch_state_dict_to_pytree`` (:108-150): it
turns the JAX package's ``(params, state)`` -- nested dicts of arrays, HWIO
conv weights, the encoder and decoder leaves stacked on a leading ``[S]``
axis -- into a ``MimoUNet`` state dict with the reference's keys:

  params['encoder']['in_conv'][s] -> encoder.in_convs.{s}
  params['encoder']['down1'][s]   -> encoder.down1s.{s}.conv
  params['core'][down2..down4]    -> core.{name}.conv
  params['core'][up1..up3]        -> core.{name}.conv
  params['decoder']['up4'][s]     -> decoder.up4s.{s}.conv
  params['decoder']['outc'][s]    -> decoder.outcs.{s}.conv

A DoubleConv maps onto ``double_conv.{0,1,3,4}`` (conv, BN, conv, BN).
Only arrays cross over (anything with ``__array__``), so this module needs
no JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from mimo_unet_torch.models.mimo_unet import MimoUNetConfig


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def _conv(sd: Dict[str, torch.Tensor], prefix: str, p: dict) -> None:
    sd[f"{prefix}.weight"] = _t(np.transpose(np.asarray(p["w"]), (3, 2, 0, 1)))
    sd[f"{prefix}.bias"] = _t(p["b"])


def _bn(sd, prefix: str, p: dict, st: dict) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    sd[f"{prefix}.running_mean"] = _t(st["mean"])
    sd[f"{prefix}.running_var"] = _t(st["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _double_conv(sd, prefix: str, p: dict, st: dict) -> None:
    _conv(sd, f"{prefix}.double_conv.0", p["conv1"])
    _bn(sd, f"{prefix}.double_conv.1", p["bn1"], st["bn1"])
    _conv(sd, f"{prefix}.double_conv.3", p["conv2"])
    _bn(sd, f"{prefix}.double_conv.4", p["bn2"], st["bn2"])


def _index(tree, i: int):
    """Leaf-wise ``tree[i]`` of a nested dict with a leading [S] axis."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def jax_pytree_to_state_dict(params: dict, state: dict,
                             cfg: MimoUNetConfig) -> Dict[str, torch.Tensor]:
    """``(params, state)`` of the JAX package -> ``MimoUNet`` state dict."""
    if cfg.mode != "bilinear":
        raise NotImplementedError("only the bilinear up mode is ported")
    sd: Dict[str, torch.Tensor] = {}
    enc_p, enc_s = params["encoder"], state["encoder"]
    dec_p, dec_s = params["decoder"], state["decoder"]
    for i in range(cfg.num_subnetworks):
        _double_conv(sd, f"encoder.in_convs.{i}",
                     _index(enc_p["in_conv"], i), _index(enc_s["in_conv"], i))
        _double_conv(sd, f"encoder.down1s.{i}.conv",
                     _index(enc_p["down1"], i), _index(enc_s["down1"], i))
    for name in ("down2", "down3", "down4"):
        _double_conv(sd, f"core.{name}.conv", params["core"][name],
                     state["core"][name])
    for name in ("up1", "up2", "up3"):
        _double_conv(sd, f"core.{name}.conv", params["core"][name]["conv"],
                     state["core"][name]["conv"])
    for i in range(cfg.num_subnetworks):
        _double_conv(sd, f"decoder.up4s.{i}.conv",
                     _index(dec_p["up4"]["conv"], i),
                     _index(dec_s["up4"]["conv"], i))
        _conv(sd, f"decoder.outcs.{i}.conv", _index(dec_p["outc"], i))
    return sd
