"""Eval-mode batch normalization with torch BatchNorm2d semantics (NCHW).

Counterpart of the eval branch of ``mimo_unet_tpu/ops/norm.py``: the
per-channel affine is computed in float32 from the running statistics, then
applied in the activation dtype (mimo_unet_tpu/ops/norm.py:88-95).  Train
mode (batch statistics, running-stat updates) is not ported yet.
"""

from __future__ import annotations

import torch


def batch_norm_eval(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    running_mean: torch.Tensor, running_var: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """Normalize [N, C, H, W] with running statistics."""
    scale = torch.rsqrt(running_var.float() + eps) * weight.float()
    shift = bias.float() - running_mean.float() * scale
    return (x * scale.to(x.dtype).view(1, -1, 1, 1)
            + shift.to(x.dtype).view(1, -1, 1, 1))
