"""U-Net building blocks as ``nn.Module``s (NCHW, eval forward).

Counterpart of ``mimo_unet_tpu/models/blocks.py``.  The module trees are
the reference's (mimo/models/mimo_components/components.py), so state-dict
keys match reference checkpoints:

  * DoubleConv (:8-33): ``double_conv`` = Sequential(conv, BN, ReLU, conv,
    BN, ReLU), 3x3 reflect convs;
  * Down (:36-57): 2x2 max pool, then ``conv`` (a DoubleConv);
  * Up (:60-120): bilinear x2 (align_corners) upsample, pad to the skip,
    concat [skip, upsampled], then ``conv`` (a DoubleConv with mid =
    in // 2);
  * OutConv (:123-129): ``conv``, a 1x1 conv.

``nn.Conv2d`` and ``nn.BatchNorm2d`` hold the parameters; the forward runs
the ops of ``mimo_unet_torch.ops`` so that bf16 rounds where the JAX
package rounds.  Both modes follow ``double_conv_apply``
(mimo_unet_tpu/models/blocks.py:62-121): in train mode the convs skip their
bias, BatchNorm normalizes with batch statistics and folds the bias into
its running mean (updated in place).  Dropout is not ported yet (the
callers raise for a nonzero rate); the unpool and transpose ``Up`` modes
are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from mimo_unet_torch.ops import (
    batch_norm_eval,
    batch_norm_train,
    conv1x1,
    conv3x3_reflect,
    max_pool_2x2,
    pad_to_match,
    upsample_bilinear_x2_align_corners,
)


def init_conv_(conv: nn.Conv2d, generator: Optional[torch.Generator]) -> None:
    """torch ``Conv2d.reset_parameters`` distribution, U(-b, b) with
    b = 1/sqrt(fan_in) for weight and bias, drawn from ``generator``."""
    fan_in = conv.weight.shape[1] * conv.weight.shape[2] * conv.weight.shape[3]
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        conv.weight.uniform_(-bound, bound, generator=generator)
        conv.bias.uniform_(-bound, bound, generator=generator)


def init_bn_(bn: nn.BatchNorm2d) -> None:
    with torch.no_grad():
        bn.weight.fill_(1.0)
        bn.bias.zero_()
        bn.running_mean.zero_()
        bn.running_var.fill_(1.0)
        bn.num_batches_tracked.zero_()


class DoubleConv(nn.Module):
    """(3x3 reflect conv -> BN -> ReLU) x 2."""

    def __init__(self, in_channels: int, out_channels: int,
                 mid_channels: Optional[int] = None):
        super().__init__()
        mid = mid_channels or out_channels
        self.double_conv = nn.Sequential(
            nn.Conv2d(in_channels, mid, 3, padding=1, padding_mode="reflect"),
            nn.BatchNorm2d(mid),
            nn.ReLU(),
            nn.Conv2d(mid, out_channels, 3, padding=1, padding_mode="reflect"),
            nn.BatchNorm2d(out_channels),
            nn.ReLU(),
        )

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        c1, bn1, _, c2, bn2, _ = self.double_conv
        init_conv_(c1, generator)
        init_bn_(bn1)
        init_conv_(c2, generator)
        init_bn_(bn2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c1, bn1, _, c2, bn2, _ = self.double_conv
        if self.training:
            y = conv3x3_reflect(x, c1.weight, None)
            y = torch.relu(batch_norm_train(y, bn1, fold_conv_bias=c1.bias))
            y = conv3x3_reflect(y, c2.weight, None)
            return torch.relu(batch_norm_train(y, bn2, fold_conv_bias=c2.bias))
        y = conv3x3_reflect(x, c1.weight, c1.bias)
        y = torch.relu(batch_norm_eval(y, bn1.weight, bn1.bias,
                                       bn1.running_mean, bn1.running_var,
                                       bn1.eps))
        y = conv3x3_reflect(y, c2.weight, c2.bias)
        return torch.relu(batch_norm_eval(y, bn2.weight, bn2.bias,
                                          bn2.running_mean, bn2.running_var,
                                          bn2.eps))


class Down(nn.Module):
    """2x2 max pool, then DoubleConv."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = DoubleConv(in_channels, out_channels)

    def forward(self, x: torch.Tensor, *, pre_pooled: bool = False
                ) -> torch.Tensor:
        """``pre_pooled``: ``x`` is already pooled (the caller pooled it
        with ``max_pool_2x2_skip`` to fold a skip consumer's cotangent into
        the pool backward, mimo_unet_tpu/models/blocks.py:132-162)."""
        return self.conv(x if pre_pooled else max_pool_2x2(x))


class Up(nn.Module):
    """Bilinear x2 upsample of ``x1``, pad to ``x2``, concat [x2, x1], conv.

    ``in_channels`` is the post-concat channel count."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = DoubleConv(in_channels, out_channels,
                               mid_channels=in_channels // 2)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        x1 = upsample_bilinear_x2_align_corners(x1)
        x1 = pad_to_match(x1, x2.shape[-2], x2.shape[-1])
        return self.conv(torch.cat([x2, x1], dim=1))


class OutConv(nn.Module):
    """1x1 conv."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 1)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        init_conv_(self.conv, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv1x1(x, self.conv.weight, self.conv.bias)
