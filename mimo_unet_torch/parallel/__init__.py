"""Parallelism over several cards (``torch.distributed``, one process a
card): the 1-D data mesh and the data x spatial mesh, the process group's
start-up, the step's collectives, the halo exchange of the spatial split
and a launcher for one host."""

from mimo_unet_torch.parallel.collectives import gather_image
from mimo_unet_torch.parallel.halo import halo_rows
from mimo_unet_torch.parallel.mesh import (
    DATA_AXIS,
    SPATIAL_AXIS,
    ImageSharding,
    Mesh,
    Mesh2D,
    check_spatial_height,
    ct_mesh_scope,
    current_ct_mesh,
    image_sharding,
    make_mesh,
    make_mesh_2d,
    pad_batch_to_divisible,
    shard_batch,
    shard_image,
)
from mimo_unet_torch.parallel.multihost import host_local_batch_slice, initialize_multihost

__all__ = [
    "DATA_AXIS", "SPATIAL_AXIS", "ImageSharding", "Mesh", "Mesh2D",
    "check_spatial_height", "ct_mesh_scope", "current_ct_mesh", "gather_image",
    "halo_rows", "image_sharding", "make_mesh", "make_mesh_2d",
    "pad_batch_to_divisible", "shard_batch", "shard_image",
    "host_local_batch_slice", "initialize_multihost",
]
