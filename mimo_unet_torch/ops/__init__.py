"""Plain PyTorch ops of the MIMO U-Net (NCHW activations)."""

from mimo_unet_torch.ops.conv import conv1x1, conv3x3_reflect
from mimo_unet_torch.ops.norm import batch_norm_eval, batch_norm_train
from mimo_unet_torch.ops.pooling import max_pool_2x2, max_pool_2x2_skip
from mimo_unet_torch.ops.resize import (
    pad_to_match,
    upsample_bilinear_x2_align_corners,
)

__all__ = [
    "batch_norm_eval",
    "batch_norm_train",
    "conv1x1",
    "conv3x3_reflect",
    "max_pool_2x2",
    "max_pool_2x2_skip",
    "pad_to_match",
    "upsample_bilinear_x2_align_corners",
]
