"""2x2 max pooling (NCHW) with the JAX package's backward.

Counterpart of ``mimo_unet_tpu/ops/pooling.py`` ``max_pool_2x2`` (:23-72)
and ``max_pool_2x2_skip`` (:74-108) for the reference ``Down`` block
(components.py:36-57).  An odd trailing row or column is dropped (torch
floor).

The backward routes the cotangent through an equality mask: under exact
ties inside a window *every* tied element gets the gradient.
``F.max_pool2d``'s own backward gives it to one element, and ties are
common in bf16 after a ReLU, so it would break gradient parity.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _pool_bwd(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Equality-mask backward: [N, C, H/2, W/2] cotangent -> [N, C, H, W]."""
    n, c, h, w = x.shape
    he, we = h - h % 2, w - w % 2
    xw = x[:, :, :he, :we].reshape(n, c, he // 2, 2, we // 2, 2)
    mask = (xw == y[:, :, :, None, :, None]).to(g.dtype)
    gx = (mask * g[:, :, :, None, :, None]).reshape(n, c, he, we)
    if (he, we) != (h, w):
        gx = F.pad(gx, (0, w - we, 0, h - he))
    return gx


class _MaxPool2x2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = F.max_pool2d(x, 2)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return _pool_bwd(x, y, g)


class _MaxPool2x2Skip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = F.max_pool2d(x, 2)
        ctx.save_for_backward(x, y)
        return y, x.view_as(x)

    @staticmethod
    def backward(ctx, g, g_skip):
        x, y = ctx.saved_tensors
        gx = _pool_bwd(x, y, g)
        return gx if g_skip is None else gx + g_skip.to(gx.dtype)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """[N, C, H, W] -> [N, C, H // 2, W // 2]."""
    return _MaxPool2x2.apply(x)


def max_pool_2x2_skip(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pooled, skip=x) for a tensor that feeds both a 2x2 max pool and a
    skip connection; the skip's cotangent is added inside the pool's
    backward (one pass, one rounding)."""
    return _MaxPool2x2Skip.apply(x)
