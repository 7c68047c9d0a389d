"""Hand-written Hopper kernels of the eval and train paths, each beside its
plain PyTorch version.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel (built at first use from ``mimo_unet_torch/csrc``) or
raises.  Each wrapper counts its launches in ``<wrapper>.launches``.
"""

from mimo_unet_torch.kernels.conv3x3_train import (
    Conv3x3Train,
    conv3x3_dw,
    conv3x3_dw_plain,
    conv3x3_dx,
    conv3x3_dx_fold,
    conv3x3_dx_fold_plain,
    conv3x3_dx_plain,
    conv3x3_fwd,
    conv3x3_fwd_plain,
)
from mimo_unet_torch.kernels.fused_double_conv import (
    fused_double_conv,
    fused_double_conv9,
    fused_double_conv9_plain,
    fused_double_conv_plain,
)
from mimo_unet_torch.kernels.pool2x2 import (
    MaxPool2x2,
    MaxPool2x2Skip,
    max_pool2x2,
    max_pool2x2_bwd,
    max_pool2x2_bwd_plain,
    max_pool2x2_plain,
)
from mimo_unet_torch.kernels.pool_w import pool_w, pool_w_plain
from mimo_unet_torch.kernels.train_elem import (
    AffineRelu,
    Conv1x1,
    Conv1x1Prelu,
    affine_relu,
    affine_relu_bwd,
    affine_relu_bwd_plain,
    affine_relu_plain,
    conv1x1,
    conv1x1_bwd,
    conv1x1_bwd_plain,
    conv1x1_plain,
    conv1x1_prelu,
    conv1x1_prelu_bwd,
    conv1x1_prelu_bwd_plain,
    conv1x1_prelu_plain,
    g_eff,
    g_eff_plain,
)
from mimo_unet_torch.kernels.upsample2x import (
    Upsample2x,
    lerp_h2x_transpose,
    lerp_h2x_transpose_plain,
    upsample2x,
    upsample2x_bwd,
    upsample2x_bwd_plain,
    upsample2x_plain,
)
from mimo_unet_torch.kernels.upsample_w2x import (
    UpsampleW2x,
    upsample_w2x,
    upsample_w2x_bwd,
    upsample_w2x_bwd_plain,
    upsample_w2x_plain,
)

EVAL_KERNELS = (fused_double_conv, fused_double_conv9, pool_w, upsample_w2x)
TRAIN_KERNELS = (conv3x3_fwd, conv3x3_dx, conv3x3_dx_fold, conv3x3_dw, g_eff,
                 affine_relu, affine_relu_bwd, conv1x1_prelu,
                 conv1x1_prelu_bwd)
# K11: the out-conv of the dropout routes (MC-dropout eval: forward; train
# with the elementwise final dropout: forward and backward)
DROPOUT_KERNELS = (conv1x1, conv1x1_bwd)
# K10 and K13: the train route's 2x2 pools (in_conv -> down1, down1 ->
# core) and the decoder's x2 upsample, forward and backward
RESAMPLE_KERNELS = (max_pool2x2, max_pool2x2_bwd, upsample2x, upsample2x_bwd)
# K4b and K14: the backward of the x2-half train decoder (its forward is
# K4, upsample_w2x, with the H lerp staged in the conv kernels)
X2_HALF_KERNELS = (upsample_w2x_bwd, lerp_h2x_transpose)
KERNELS = (EVAL_KERNELS + TRAIN_KERNELS + DROPOUT_KERNELS + RESAMPLE_KERNELS
           + X2_HALF_KERNELS)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


__all__ = [
    "AffineRelu",
    "Conv1x1",
    "Conv1x1Prelu",
    "Conv3x3Train",
    "DROPOUT_KERNELS",
    "EVAL_KERNELS",
    "KERNELS",
    "MaxPool2x2",
    "MaxPool2x2Skip",
    "RESAMPLE_KERNELS",
    "TRAIN_KERNELS",
    "Upsample2x",
    "UpsampleW2x",
    "X2_HALF_KERNELS",
    "affine_relu",
    "affine_relu_bwd",
    "affine_relu_bwd_plain",
    "affine_relu_plain",
    "conv1x1",
    "conv1x1_bwd",
    "conv1x1_bwd_plain",
    "conv1x1_plain",
    "conv1x1_prelu",
    "conv1x1_prelu_bwd",
    "conv1x1_prelu_bwd_plain",
    "conv1x1_prelu_plain",
    "conv3x3_dw",
    "conv3x3_dw_plain",
    "conv3x3_dx",
    "conv3x3_dx_fold",
    "conv3x3_dx_fold_plain",
    "conv3x3_dx_plain",
    "conv3x3_fwd",
    "conv3x3_fwd_plain",
    "fused_double_conv",
    "fused_double_conv9",
    "fused_double_conv9_plain",
    "fused_double_conv_plain",
    "g_eff",
    "g_eff_plain",
    "launch_counts",
    "lerp_h2x_transpose",
    "lerp_h2x_transpose_plain",
    "max_pool2x2",
    "max_pool2x2_bwd",
    "max_pool2x2_bwd_plain",
    "max_pool2x2_plain",
    "pool_w",
    "pool_w_plain",
    "reset_launch_counts",
    "upsample2x",
    "upsample2x_bwd",
    "upsample2x_bwd_plain",
    "upsample2x_plain",
    "upsample_w2x",
    "upsample_w2x_bwd",
    "upsample_w2x_bwd_plain",
    "upsample_w2x_plain",
]
