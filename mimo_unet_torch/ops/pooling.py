"""2x2 max pooling (NCHW) with the JAX package's backward, and the
pooling indices of the unpool decoder.

Counterpart of ``mimo_unet_tpu/ops/pooling.py`` ``max_pool_2x2`` (:23-72),
``max_pool_2x2_skip`` (:74-108), ``max_pool_2x2_with_indices``,
``max_unpool_2x2`` and ``local_to_torch_flat_indices`` (:110-153) for the
reference ``Down`` and unpool ``Up`` blocks (components.py:36-120).  An
odd trailing row or column is dropped (torch floor).

The backward routes the cotangent through an equality mask: under exact
ties inside a window *every* tied element gets the gradient.
``F.max_pool2d``'s own backward gives it to one element, and ties are
common in bf16 after a ReLU, so it would break gradient parity.  The
index pool's backward is the gradient of the JAX op's ``jnp.max``
instead: tied maxima share the cotangent equally.

Under a spatial mesh (``parallel/mesh.py`` ``Mesh2D``) the pools run on
each rank's rows as they are: every window lies inside one shard when each
shard holds an even number of rows, which ``check_spatial_height`` makes
a rule for the model's input; a pool of an odd shard raises.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from mimo_unet_torch.parallel.mesh import check_spatial_height, current_ct_mesh, spatial_count


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


def _windows(x: torch.Tensor) -> torch.Tensor:
    """[N, C, H, W] -> [N, C, H/2, W/2, 4]: each 2x2 window in row-major
    order, an odd trailing row or column dropped."""
    n, c, h, w = x.shape
    x = x[:, :, :h - h % 2, :w - w % 2]
    return (x.reshape(n, c, h // 2, 2, w // 2, 2).permute(0, 1, 2, 4, 3, 5)
            .reshape(n, c, h // 2, w // 2, 4))


class _MaxPool2x2WithIndices(torch.autograd.Function):
    """The pooled max and its window code; the backward splits the
    cotangent equally among tied maxima, as the gradient of ``jnp.max``
    does (``g * (x == max) / count``)."""

    @staticmethod
    def forward(ctx, x):
        xw = _windows(x)
        y = xw.amax(dim=-1)
        below = xw != y[..., None]
        a, b, c = below[..., 0], below[..., 1], below[..., 2]
        ab = a & b
        idx = a.to(torch.uint8) + ab + (ab & c)  # the first maximum's code
        ctx.mark_non_differentiable(idx)
        ctx.save_for_backward(x, y)
        return y, idx

    @staticmethod
    def backward(ctx, g, g_idx):
        x, y = ctx.saved_tensors
        at_max = (_windows(x) == y[..., None]).to(g.dtype)
        gw = (g / at_max.sum(-1))[..., None] * at_max
        n, c, hp, wp, _ = gw.shape
        gx = (gw.reshape(n, c, hp, wp, 2, 2).permute(0, 1, 2, 4, 3, 5)
              .reshape(n, c, 2 * hp, 2 * wp))
        h, w = x.shape[-2:]
        return F.pad(gx, (0, w - 2 * wp, 0, h - 2 * hp))


def _check_shard(x: torch.Tensor) -> None:
    """Under a spatial mesh, raise unless the shard's rows pair up."""
    mesh = current_ct_mesh()
    check_spatial_height(x.shape[-2] * spatial_count(mesh), mesh, levels=1)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """[N, C, H, W] -> [N, C, H // 2, W // 2]."""
    _check_shard(x)
    return _MaxPool2x2.apply(x)


def max_pool_2x2_skip(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pooled, skip=x) for a tensor that feeds both a 2x2 max pool and a
    skip connection; the skip's cotangent is added inside the pool's
    backward (one pass, one rounding)."""
    _check_shard(x)
    return _MaxPool2x2Skip.apply(x)


def max_pool_2x2_with_indices(x: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pooled [N, C, H // 2, W // 2], code uint8 of the same shape): the
    code is the row-major position 0..3 of the window's maximum, the first
    one under ties (torch's ``MaxPool2d(return_indices=True)`` order;
    ``local_to_torch_flat_indices`` gives torch's flat indices)."""
    _check_shard(x)
    return _MaxPool2x2WithIndices.apply(x)


def max_unpool_2x2(x: torch.Tensor, idx: torch.Tensor, out_h: int,
                   out_w: int) -> torch.Tensor:
    """The inverse of ``max_pool_2x2_with_indices``: each value of
    [N, C, Hp, Wp] ``x`` goes to its window's position ``idx``, zeros
    elsewhere, zero-padded at the bottom and right to (``out_h``,
    ``out_w``).  Its backward gathers the cotangent at the positions."""
    n, c, hp, wp = x.shape
    onehot = idx[..., None] == torch.arange(4, device=idx.device, dtype=idx.dtype)
    y = (x[..., None] * onehot.to(x.dtype)).reshape(n, c, hp, wp, 2, 2)
    y = y.permute(0, 1, 2, 4, 3, 5).reshape(n, c, 2 * hp, 2 * wp)
    if (out_h, out_w) != (2 * hp, 2 * wp):
        y = F.pad(y, (0, out_w - 2 * wp, 0, out_h - 2 * hp))
    return y


def local_to_torch_flat_indices(idx: torch.Tensor, in_w: int) -> torch.Tensor:
    """Window codes [N, C, Hp, Wp] -> torch ``MaxPool2d`` flat indices
    ``h * in_w + w`` into the pooled input (int64)."""
    hp, wp = idx.shape[-2:]
    i = torch.arange(hp, device=idx.device).view(hp, 1)
    j = torch.arange(wp, device=idx.device).view(1, wp)
    r, s = idx.long() // 2, idx.long() % 2
    return (2 * i + r) * in_w + (2 * j + s)
