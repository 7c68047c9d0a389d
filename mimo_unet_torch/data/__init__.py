"""Data pipeline of the port: ``data/core.py`` (host batches, the
prefetcher, the split pinned on the card) and the loaders of the datasets
the reference trains on (``nyuv2``, ``sen12tp``, ``make3d``, ``muad``),
whose file readers (h5py, cv2, imageio, scipy) are imported where they
are used."""

from mimo_unet_torch.data.core import (
    ArrayDataset,
    DataModule,
    DeviceDataset,
    PartialDeviceDataset,
    device_cache_budget_bytes,
    iterate_batches,
    prefetch_to_device,
)

__all__ = ["ArrayDataset", "DataModule", "DeviceDataset", "PartialDeviceDataset",
           "device_cache_budget_bytes", "iterate_batches", "prefetch_to_device"]
