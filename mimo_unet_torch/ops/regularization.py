"""DropBlock spatial regularization (NCHW).

Counterpart of ``mimo_unet_tpu/ops/regularization.py`` (:20-58; reference
mimo/regularization.py:9-71, a vendored DropBlock2D that no model of the
reference uses): contiguous ``block_size`` x ``block_size`` regions are
dropped instead of single pixels, and the survivors rescaled.

gamma = (rate / block_size^2) * (H W / ((H - block_size + 1)(W -
block_size + 1))); block centers are drawn in the valid interior, padded
by (block_size // 2, block_size - 1 - block_size // 2) and dilated to
blocks by a stride-1 ``block_size`` max window with the JAX ``SAME``
padding; the output is ``x * keep / max(mean(keep), 1e-7)``.  The centers
come from an explicit ``torch.Generator`` (the bits are torch's, not
JAX's); ``drop_block_keep`` takes drawn centers, so another draw (the JAX
package's, in the tests) can be replayed through it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def drop_block_gamma(rate: float, block_size: int, h: int, w: int) -> float:
    """The probability of a block center in the valid interior."""
    return ((rate / (block_size ** 2)) * (h * w)
            / ((h - block_size + 1) * (w - block_size + 1)))


def drop_block_keep(centers: torch.Tensor, block_size: int) -> torch.Tensor:
    """Block centers [N, C, H - bs + 1, W - bs + 1] (0/1) -> the keep
    mask [N, C, H, W] (0/1), in the centers' dtype."""
    lo = block_size // 2
    hi = block_size - 1 - lo
    centers = F.pad(centers, (lo, hi, lo, hi))
    same_lo = (block_size - 1) // 2  # the SAME window's split
    same_hi = block_size - 1 - same_lo
    block = F.max_pool2d(F.pad(centers, (same_lo, same_hi, same_lo, same_hi)),
                         block_size, stride=1)
    return 1.0 - block


def drop_block_apply(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """``x * keep / max(mean(keep), 1e-7)``, the mean taken as XLA takes
    ``jnp.mean``: the sum times the reciprocal of the count."""
    inv_n = torch.tensor(1.0 / keep.numel(), dtype=keep.dtype, device=keep.device)
    return x * keep / torch.clamp_min(keep.sum() * inv_n, 1e-7)


def drop_block_2d(x: torch.Tensor, rate: float, block_size: int,
                  generator: Optional[torch.Generator], *,
                  deterministic: bool) -> torch.Tensor:
    """DropBlock of NCHW ``x``; identity when ``deterministic`` or at rate
    0.  ``generator`` (on ``x``'s device) draws the centers."""
    if deterministic or rate == 0.0:
        return x
    n, c, h, w = x.shape
    gamma = drop_block_gamma(rate, block_size, h, w)
    centers = (torch.rand((n, c, h - block_size + 1, w - block_size + 1),
                          generator=generator, device=x.device) < gamma)
    return drop_block_apply(x, drop_block_keep(centers.to(x.dtype), block_size))
