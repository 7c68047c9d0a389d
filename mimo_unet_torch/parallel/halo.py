"""The halo exchange of a spatial (H) split: one neighbour row each side.

Under a ``Mesh2D`` every rank holds its rows of each image's height, and a
3x3 conv or a x2 align-corners upsample at a shard's edge reads one row of
the neighbouring shard.  XLA's partitioner inserts that exchange for the
JAX package (mimo_unet_tpu/parallel/mesh.py:76-86); the port calls
``halo_rows`` from the plain ops (``ops/conv.py``, ``ops/resize.py``).

The forward gathers every rank's first and last rows over the spatial
group, as ``collectives.all_gather_rows`` gathers batch rows: an all-reduce
of a zero-filled ``[spatial, 2, ...]`` buffer in which each rank fills its
own slot.  The backward sends each borrowed row's cotangent back to its
owner through the same kind of buffer and adds it there, so gradients are
the unsharded step's.  Only ``all_reduce`` is used, so one code path serves
gloo and NCCL (``parallel/collectives.py``).  Counted as "halo" and
"halo_grad" in ``collectives.counts()``.
"""

from __future__ import annotations

import torch

from mimo_unet_torch.parallel.collectives import _all_reduce
from mimo_unet_torch.parallel.mesh import Mesh


def _edges(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A zero [spatial, 2, ...row] buffer (a row of x being x[..., r, :])."""
    return x.new_zeros((mesh.size, 2) + tuple(x.shape[:-2]) + tuple(x.shape[-1:]))


class _HaloRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        k, i = mesh.size, mesh.rank
        buf = _edges(x, mesh)
        buf[i, 0] = x[..., 0, :]
        buf[i, 1] = x[..., -1, :]
        _all_reduce(buf, mesh, "halo")
        # slot (j, 0) holds rank j's first row, (j, 1) its last; a global
        # edge borrows nothing and gets zeros
        top = buf[i - 1, 1] if i > 0 else torch.zeros_like(buf[0, 0])
        bottom = buf[i + 1, 0] if i < k - 1 else torch.zeros_like(buf[0, 0])
        return torch.cat([top.unsqueeze(-2), x, bottom.unsqueeze(-2)], dim=-2)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        k, i = mesh.size, mesh.rank
        buf = _edges(g, mesh)
        if i > 0:  # the top halo was rank i-1's last row
            buf[i - 1, 1] = g[..., 0, :]
        if i < k - 1:  # the bottom halo was rank i+1's first row
            buf[i + 1, 0] = g[..., -1, :]
        _all_reduce(buf, mesh, "halo_grad")
        gx = g[..., 1:-1, :].clone()
        gx[..., 0, :] += buf[i, 0]
        gx[..., -1, :] += buf[i, 1]
        return gx, None


def halo_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` [..., h, W] with the spatial neighbours' rows around it:
    [..., h + 2, W], row 0 the previous shard's last row and row h + 1 the
    next shard's first row, zeros past the global top and bottom.  ``mesh``
    is the spatial axis (``Mesh2D.spatial_mesh``), of several ranks; every
    rank of it must call this at the same point.  Differentiable: each
    borrowed row's cotangent is added to its owner's row."""
    return _HaloRows.apply(x, mesh)
