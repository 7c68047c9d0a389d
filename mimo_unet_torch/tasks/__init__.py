"""Tasks (PyTorch)."""

from mimo_unet_torch.tasks.evidential import EvidentialUnetTask
from mimo_unet_torch.tasks.mimo import MimoUnetTask

__all__ = ["EvidentialUnetTask", "MimoUnetTask"]
