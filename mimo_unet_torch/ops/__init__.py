"""Plain PyTorch ops of the MIMO U-Net (NCHW activations)."""

from mimo_unet_torch.ops.conv import conv1x1, conv3x3_reflect, conv_transpose2d
from mimo_unet_torch.ops.norm import batch_norm_eval, batch_norm_train
from mimo_unet_torch.ops.pooling import (
    local_to_torch_flat_indices,
    max_pool_2x2,
    max_pool_2x2_skip,
    max_pool_2x2_with_indices,
    max_unpool_2x2,
)
from mimo_unet_torch.ops.regularization import drop_block_2d
from mimo_unet_torch.ops.resize import (
    pad_to_match,
    upsample_bilinear_x2_align_corners,
)

__all__ = [
    "batch_norm_eval",
    "batch_norm_train",
    "conv1x1",
    "conv3x3_reflect",
    "conv_transpose2d",
    "drop_block_2d",
    "local_to_torch_flat_indices",
    "max_pool_2x2",
    "max_pool_2x2_skip",
    "max_pool_2x2_with_indices",
    "max_unpool_2x2",
    "pad_to_match",
    "upsample_bilinear_x2_align_corners",
]
