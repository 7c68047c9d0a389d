"""Small shared utilities (``mimo_unet_tpu/utils.py``; reference
mimo/utils.py:4-14)."""

from __future__ import annotations

import os
from argparse import ArgumentTypeError

from torch import nn


def dir_path(path: str) -> str:
    """argparse validator: the argument must be an existing directory."""
    if os.path.isdir(path):
        return path
    raise ArgumentTypeError(f"{path} is not a valid path")


def count_parameters(model: nn.Module) -> int:
    """The number of trainable parameter elements of ``model``."""
    return sum(p.numel() for p in model.parameters() if p.requires_grad)
