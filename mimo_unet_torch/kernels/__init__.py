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
from mimo_unet_torch.kernels.pool_w import pool_w, pool_w_plain
from mimo_unet_torch.kernels.train_elem import (
    AffineRelu,
    Conv1x1Prelu,
    affine_relu,
    affine_relu_bwd,
    affine_relu_bwd_plain,
    affine_relu_plain,
    conv1x1_prelu,
    conv1x1_prelu_bwd,
    conv1x1_prelu_bwd_plain,
    conv1x1_prelu_plain,
    g_eff,
    g_eff_plain,
)
from mimo_unet_torch.kernels.upsample_w2x import upsample_w2x, upsample_w2x_plain

EVAL_KERNELS = (fused_double_conv, fused_double_conv9, pool_w, upsample_w2x)
TRAIN_KERNELS = (conv3x3_fwd, conv3x3_dx, conv3x3_dx_fold, conv3x3_dw, g_eff,
                 affine_relu, affine_relu_bwd, conv1x1_prelu,
                 conv1x1_prelu_bwd)
KERNELS = EVAL_KERNELS + TRAIN_KERNELS


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


__all__ = [
    "AffineRelu",
    "Conv1x1Prelu",
    "Conv3x3Train",
    "EVAL_KERNELS",
    "KERNELS",
    "TRAIN_KERNELS",
    "affine_relu",
    "affine_relu_bwd",
    "affine_relu_bwd_plain",
    "affine_relu_plain",
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
    "pool_w",
    "pool_w_plain",
    "reset_launch_counts",
    "upsample_w2x",
    "upsample_w2x_plain",
]
