"""2x2 max pooling (NCHW), forward only.

Counterpart of ``mimo_unet_tpu/ops/pooling.py`` ``max_pool_2x2`` for the
reference ``Down`` block (components.py:36-57).  An odd trailing row or
column is dropped (torch floor).  The backward with its every-tied-element
rule, and pooling with indices, come with the train path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """[N, C, H, W] -> [N, C, H // 2, W // 2]."""
    return F.max_pool2d(x, 2)
