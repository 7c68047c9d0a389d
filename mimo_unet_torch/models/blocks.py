"""U-Net building blocks as ``nn.Module``s (NCHW, eval forward).

Counterpart of ``mimo_unet_tpu/models/blocks.py``.  The module trees are
the reference's (mimo/models/mimo_components/components.py), so state-dict
keys match reference checkpoints:

  * DoubleConv (:8-33): ``double_conv`` = Sequential(conv, BN, ReLU, conv,
    BN, ReLU), 3x3 reflect convs;
  * Down (:36-57): 2x2 max pool (with its indices for the unpool
    decoder), then ``conv`` (a DoubleConv);
  * Up (:60-120): upsample ``x1``, pad to the skip, concat [skip,
    upsampled], then ``conv``.  Three modes: bilinear x2 (align_corners)
    and unpool (``MaxUnpool2d`` at the Down's indices), each with a
    DoubleConv of mid = in // 2; transpose, an ``up`` ConvTranspose2d
    (2x2, stride 2) halving x1's channels, then a DoubleConv without mid
    channels (mimo_unet_tpu/models/blocks.py:184-291);
  * OutConv (:123-129): ``conv``, a 1x1 conv.

``nn.Conv2d`` and ``nn.BatchNorm2d`` hold the parameters; the forward runs
the ops of ``mimo_unet_torch.ops`` so that bf16 rounds where the JAX
package rounds.  Both modes follow ``double_conv_apply``
(mimo_unet_tpu/models/blocks.py:62-121): in train mode the convs skip their
bias, BatchNorm normalizes with batch statistics and folds the bias into
its running mean (updated in place).  Every DoubleConv ends in its
Dropout2d site (reference components.py:29; mimo_unet_tpu/models/
blocks.py:119-120): the caller passes the site's keep mask, live in train
mode and under MC dropout, where BatchNorm stays in eval mode as in the
reference.
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
    conv_transpose2d,
    max_pool_2x2,
    max_pool_2x2_with_indices,
    max_unpool_2x2,
    pad_to_match,
    upsample_bilinear_x2_align_corners,
)
from mimo_unet_torch.ops.dropout import Drop, dropout2d


def init_conv_(conv: nn.Module, generator: Optional[torch.Generator]) -> None:
    """torch ``Conv2d.reset_parameters`` distribution, U(-b, b) with
    b = 1/sqrt(fan_in) for weight and bias, drawn from ``generator``.  For
    a ``ConvTranspose2d`` ([in, out, k, k]) fan_in is out * k * k, as
    torch's own init and ``conv_transpose2d_init``
    (mimo_unet_tpu/ops/conv.py:271-298) count it."""
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

    def forward(self, x: torch.Tensor, drop: Optional[Drop] = None
                ) -> torch.Tensor:
        """``drop``: the Dropout2d site's mask when it is live."""
        c1, bn1, _, c2, bn2, _ = self.double_conv
        if self.training:
            y = conv3x3_reflect(x, c1.weight, None)
            y = torch.relu(batch_norm_train(y, bn1, fold_conv_bias=c1.bias))
            y = conv3x3_reflect(y, c2.weight, None)
            y = torch.relu(batch_norm_train(y, bn2, fold_conv_bias=c2.bias))
            return dropout2d(y, drop)
        y = conv3x3_reflect(x, c1.weight, c1.bias)
        y = torch.relu(batch_norm_eval(y, bn1.weight, bn1.bias,
                                       bn1.running_mean, bn1.running_var,
                                       bn1.eps))
        y = conv3x3_reflect(y, c2.weight, c2.bias)
        y = torch.relu(batch_norm_eval(y, bn2.weight, bn2.bias,
                                       bn2.running_mean, bn2.running_var,
                                       bn2.eps))
        return dropout2d(y, drop)


class Down(nn.Module):
    """2x2 max pool, then DoubleConv; with ``use_pooling_indices`` the
    forward returns (y, the pool's window codes) for the unpool decoder."""

    def __init__(self, in_channels: int, out_channels: int,
                 use_pooling_indices: bool = False):
        super().__init__()
        self.conv = DoubleConv(in_channels, out_channels)
        self.use_pooling_indices = use_pooling_indices

    def forward(self, x: torch.Tensor, *, pre_pooled: bool = False,
                drop: Optional[Drop] = None):
        """``pre_pooled``: ``x`` is already pooled (the caller pooled it
        with ``max_pool_2x2_skip`` to fold a skip consumer's cotangent into
        the pool backward, mimo_unet_tpu/models/blocks.py:132-162)."""
        if self.use_pooling_indices:
            y, idx = max_pool_2x2_with_indices(x)
            return self.conv(y, drop), idx
        return self.conv(x if pre_pooled else max_pool_2x2(x), drop)


class Up(nn.Module):
    """Upsample ``x1`` (``mode`` "bilinear", "unpool" or "transpose"), pad
    to ``x2``, concat [x2, x1], conv.

    ``in_channels`` is the post-concat channel count; ``x1_channels``
    (transpose only) the channels of the x1 the ConvTranspose2d receives
    where they differ from ``in_channels`` (the MIMO decoder's up4: the
    corrected channel math of mimo_unet_tpu/models/mimo_unet.py:150-158)."""

    def __init__(self, in_channels: int, out_channels: int, mode: str,
                 x1_channels: Optional[int] = None):
        super().__init__()
        self.mode = mode
        if mode == "transpose":
            x1c = in_channels if x1_channels is None else x1_channels
            self.up = nn.ConvTranspose2d(x1c, x1c // 2, 2, stride=2)
            self.conv = DoubleConv(in_channels, out_channels)
        else:
            self.conv = DoubleConv(in_channels, out_channels,
                                   mid_channels=in_channels // 2)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor,
                drop: Optional[Drop] = None,
                indices: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``indices``: the window codes that unpool ``x1`` (unpool mode)."""
        if self.mode == "bilinear":
            x1 = upsample_bilinear_x2_align_corners(x1)
        elif self.mode == "unpool":
            x1 = max_unpool_2x2(x1, indices, 2 * x1.shape[-2], 2 * x1.shape[-1])
        else:
            x1 = conv_transpose2d(x1, self.up.weight, self.up.bias)
        x1 = pad_to_match(x1, x2.shape[-2], x2.shape[-1])
        return self.conv(torch.cat([x2, x1], dim=1), drop)


class OutConv(nn.Module):
    """1x1 conv."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 1)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        init_conv_(self.conv, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv1x1(x, self.conv.weight, self.conv.bias)
