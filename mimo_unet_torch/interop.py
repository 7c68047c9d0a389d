"""Weight transplant from the JAX package's pytrees into the port, and
reference Lightning checkpoints.

``jax_pytree_to_state_dict`` is the exact inverse of
``mimo_unet_tpu/interop.py`` ``torch_state_dict_to_pytree`` (:108-150): it
turns the JAX package's ``(params, state)`` -- nested dicts of arrays, HWIO
conv weights, the encoder and decoder leaves stacked on a leading ``[S]``
axis -- into a ``MimoUNet`` state dict with the reference's keys:

  params['encoder']['in_conv'][s] -> encoder.in_convs.{s}
  params['encoder']['down1'][s]   -> encoder.down1s.{s}.conv
  params['core'][down2..down4]    -> core.{name}.conv
  params['core'][up1..up3]        -> core.{name}.conv (and .up)
  params['decoder']['up4'][s]     -> decoder.up4s.{s}.conv (and .up)
  params['decoder']['outc'][s]    -> decoder.outcs.{s}.conv

A DoubleConv maps onto ``double_conv.{0,1,3,4}`` (conv, BN, conv, BN); the
transpose mode's ``up`` ConvTranspose2d goes from the JAX HWIO
[kh, kw, in, out] back to torch's [in, out, kh, kw]
(mimo_unet_tpu/interop.py:46-51, :80-86).
``jax_loss_buffer_to_state`` carries the train state's loss-buffer ring
over; Adam's moments start at zero on both sides and need no converter.
Only arrays cross over (anything with ``__array__``), so this module needs
no JAX.

``load_reference_checkpoint`` reads a ``.ckpt`` of the PyTorch reference
(``MimoUnetModel`` or ``EvidentialUnetModel``; ``mimo_unet_tpu/interop.py``
:153-177): the port's module names are the reference's, so its state dict
loads as it is once ``normalize_state_dict`` has stripped Lightning's
``model.`` and torch.compile's ``_orig_mod.`` prefixes.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from mimo_unet_torch.loss_buffer import LossBufferState
from mimo_unet_torch.models.mimo_unet import MimoUNetConfig


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def _conv(sd: Dict[str, torch.Tensor], prefix: str, p: dict) -> None:
    sd[f"{prefix}.weight"] = _t(np.transpose(np.asarray(p["w"]), (3, 2, 0, 1)))
    sd[f"{prefix}.bias"] = _t(p["b"])


def _conv_transpose(sd: Dict[str, torch.Tensor], prefix: str, p: dict) -> None:
    sd[f"{prefix}.weight"] = _t(np.transpose(np.asarray(p["w"]), (2, 3, 0, 1)))
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


def _up(sd, prefix: str, p: dict, st: dict, mode: str) -> None:
    _double_conv(sd, f"{prefix}.conv", p["conv"], st["conv"])
    if mode == "transpose":
        _conv_transpose(sd, f"{prefix}.up", p["up"])


def _index(tree, i: int):
    """Leaf-wise ``tree[i]`` of a nested dict with a leading [S] axis."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def jax_pytree_to_state_dict(params: dict, state: dict,
                             cfg: MimoUNetConfig) -> Dict[str, torch.Tensor]:
    """``(params, state)`` of the JAX package -> ``MimoUNet`` state dict."""
    mode = cfg.mode
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
        _up(sd, f"core.{name}", params["core"][name], state["core"][name], mode)
    for i in range(cfg.num_subnetworks):
        _up(sd, f"decoder.up4s.{i}", _index(dec_p["up4"], i),
            _index(dec_s["up4"], i), mode)
        _conv(sd, f"decoder.outcs.{i}.conv", _index(dec_p["outc"], i))
    return sd


def jax_loss_buffer_to_state(loss_buffer) -> LossBufferState:
    """The JAX package's ``LossBufferState`` (buffer [size, S], index) ->
    the port's, on the CPU."""
    return LossBufferState(buffer=_t(loss_buffer.buffer).float(),
                           index=int(np.asarray(loss_buffer.index)))


def normalize_state_dict(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Strip Lightning / torch.compile prefixes ('model.', '_orig_mod.')
    (``mimo_unet_tpu/interop.py:96-106``)."""
    out = {}
    for k, v in sd.items():
        for prefix in ("model.", "_orig_mod."):
            while k.startswith(prefix):
                k = k[len(prefix):]
        k = k.replace("._orig_mod.", ".")
        out[k] = v
    return out


def load_reference_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], dict]:
    """A Lightning checkpoint of the PyTorch reference -> (the ``MimoUNet``
    state dict on the CPU, hyperparameters), the counterpart of
    ``mimo_unet_tpu/interop.py:153-177``; the model's configuration comes
    from the task the hyperparameters build (``train/checkpoint.py``).
    The file is a pickle (Lightning's hyperparameters are objects), so it
    is read with ``weights_only=False``, as the JAX package reads it: load
    only checkpoints you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return (normalize_state_dict(dict(ckpt["state_dict"])),
            dict(ckpt.get("hyper_parameters", {})))
