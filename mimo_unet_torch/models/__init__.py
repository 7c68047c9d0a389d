"""MIMO U-Net models (PyTorch)."""

from mimo_unet_torch.models.mimo_unet import MimoUNet, MimoUNetConfig

__all__ = ["MimoUNet", "MimoUNetConfig"]
