"""2D convolutions (NCHW activations, OIHW weights).

Counterpart of ``mimo_unet_tpu/ops/conv.py`` for the reference blocks
(mimo/models/mimo_components/components.py:23-28): 3x3 convs with torch's
``padding_mode="reflect"`` and 1x1 output convs.

The activation dtype is the compute dtype: weights are cast to it and the
output stays in it (the bf16 recipe of the JAX package).  The bias is added
after the convolution, in the activation dtype, as the JAX package does, so
bf16 outputs round at the same two places.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def conv3x3_reflect(x: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor], *, groups: int = 1
                    ) -> torch.Tensor:
    """3x3 conv with 1-pixel reflect padding: [N, C, H, W] -> [N, O, H, W].
    ``bias=None`` skips the bias add (train mode: the BatchNorm that
    follows cancels it, mimo_unet_tpu/models/blocks.py:86-91)."""
    y = F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"),
                 weight.to(x.dtype), None, groups=groups)
    if bias is None:
        return y
    return y + bias.to(y.dtype).view(1, -1, 1, 1)


def conv1x1(x: torch.Tensor, weight: torch.Tensor,
            bias: torch.Tensor, *, groups: int = 1) -> torch.Tensor:
    """1x1 conv: [N, C, H, W] -> [N, O, H, W]."""
    y = F.conv2d(x, weight.to(x.dtype), None, groups=groups)
    return y + bias.to(y.dtype).view(1, -1, 1, 1)
