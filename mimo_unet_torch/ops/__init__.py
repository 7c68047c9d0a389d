"""Plain PyTorch ops of the MIMO U-Net (NCHW activations)."""

from mimo_unet_torch.ops.conv import conv1x1, conv3x3_reflect
from mimo_unet_torch.ops.norm import batch_norm_eval
from mimo_unet_torch.ops.pooling import max_pool_2x2
from mimo_unet_torch.ops.resize import (
    pad_to_match,
    upsample_bilinear_x2_align_corners,
)

__all__ = [
    "batch_norm_eval",
    "conv1x1",
    "conv3x3_reflect",
    "max_pool_2x2",
    "pad_to_match",
    "upsample_bilinear_x2_align_corners",
]
