"""Batch normalization with torch BatchNorm2d semantics (NCHW).

Counterpart of ``mimo_unet_tpu/ops/norm.py``: the per-channel affine is
computed in float32, then applied in the activation dtype (:80-95).

Train mode (:63-86) normalizes with the *biased* batch variance and updates
the running statistics in place with the *unbiased* one, momentum 0.1.
With ``fold_conv_bias`` the producing conv skipped its bias (it cancels
out of ``x - mean``), and the bias is added to the running mean only.

Under a mesh of several ranks (``parallel/mesh.py`` ``ct_mesh_scope``)
the per-channel sums and sums of squares are summed over the ranks and
divided by the global count, so every rank normalizes with the global
batch's statistics (what the JAX package's global-batch math gives).  On
a data x spatial mesh the sums run over every rank of it, each holding its
batch rows and its height rows, and the count is the local one times
data x spatial.
"""

from __future__ import annotations

from typing import Optional

import torch

from mimo_unet_torch.parallel.collectives import all_reduce_sum
from mimo_unet_torch.parallel.mesh import current_ct_mesh, rank_count


def batch_norm_eval(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    running_mean: torch.Tensor, running_var: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """Normalize [N, C, H, W] with running statistics."""
    scale = torch.rsqrt(running_var.float() + eps) * weight.float()
    shift = bias.float() - running_mean.float() * scale
    return (x * scale.to(x.dtype).view(1, -1, 1, 1)
            + shift.to(x.dtype).view(1, -1, 1, 1))


@torch.no_grad()
def update_running_stats(running_mean: torch.Tensor, running_var: torch.Tensor,
                         mean: torch.Tensor, var: torch.Tensor, count: int,
                         momentum: float = 0.1) -> None:
    """In place: r = (1 - momentum) * r + momentum * batch_stat, with the
    unbiased variance ``var * count / (count - 1)``.  ``mean`` already
    carries any folded conv bias."""
    unbiased = var.float() * (count / max(count - 1, 1))
    running_mean.copy_((1 - momentum) * running_mean + momentum * mean.float())
    running_var.copy_((1 - momentum) * running_var + momentum * unbiased)


class _BatchSums(torch.autograd.Function):
    """Per-channel f32 (sum, sum of squares) of [N, C, H, W], stacked [2, C]
    (the form that sums over ranks), for ``E[x]`` and ``E[x^2] - E[x]^2``
    (mimo_unet_tpu/ops/norm.py:64-68).  Saves only ``x`` in its own dtype:
    autograd through the f32 upcast would keep an f32 copy of every
    normalized activation for the backward, twice a bf16 activation's
    memory."""

    @staticmethod
    def forward(ctx, x):
        xf = x.float()
        ctx.save_for_backward(x)
        return torch.stack([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3))])

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        ds, dq = g[0].view(1, -1, 1, 1), g[1].view(1, -1, 1, 1)
        return (ds + 2.0 * dq * x.float()).to(x.dtype)


def batch_norm_train(x: torch.Tensor, bn: torch.nn.BatchNorm2d, *,
                     fold_conv_bias: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Normalize [N, C, H, W] with its batch statistics (computed in f32)
    and update ``bn``'s running statistics in place; under a mesh of
    several ranks, with the global batch's."""
    mesh = current_ct_mesh()
    count = x.numel() // x.shape[1] * rank_count(mesh)
    s, q = all_reduce_sum(_BatchSums.apply(x), mesh).unbind(0)
    mean = s / count
    var = q / count - mean * mean
    stat_mean = mean.detach()
    if fold_conv_bias is not None:
        stat_mean = stat_mean + fold_conv_bias.detach().float()
    update_running_stats(bn.running_mean, bn.running_var, stat_mean,
                         var.detach(), count, bn.momentum)
    with torch.no_grad():
        bn.num_batches_tracked.add_(1)
    inv = torch.rsqrt(var + bn.eps) * bn.weight.float()
    shift = bn.bias.float() - mean * inv
    return (x * inv.to(x.dtype).view(1, -1, 1, 1)
            + shift.to(x.dtype).view(1, -1, 1, 1))
