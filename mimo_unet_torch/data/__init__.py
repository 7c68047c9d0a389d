"""Data pipeline of the port (``data/core.py``)."""

from mimo_unet_torch.data.core import ArrayDataset, DataModule, prefetch_to_device

__all__ = ["ArrayDataset", "DataModule", "prefetch_to_device"]
