"""Hand-written Hopper kernels of the eval path, each beside its plain
PyTorch version.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel (built at first use from ``mimo_unet_torch/csrc``) or
raises.  Each wrapper counts its launches in ``<wrapper>.launches``.
"""

from mimo_unet_torch.kernels.fused_double_conv import (
    fused_double_conv,
    fused_double_conv9,
    fused_double_conv9_plain,
    fused_double_conv_plain,
)
from mimo_unet_torch.kernels.pool_w import pool_w, pool_w_plain
from mimo_unet_torch.kernels.upsample_w2x import upsample_w2x, upsample_w2x_plain

KERNELS = (fused_double_conv, fused_double_conv9, pool_w, upsample_w2x)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


__all__ = [
    "KERNELS",
    "fused_double_conv",
    "fused_double_conv9",
    "fused_double_conv9_plain",
    "fused_double_conv_plain",
    "launch_counts",
    "pool_w",
    "pool_w_plain",
    "reset_launch_counts",
    "upsample_w2x",
    "upsample_w2x_plain",
]
