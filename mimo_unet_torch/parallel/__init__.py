"""Data parallelism over several cards (``torch.distributed``, one process a
card): the mesh, the process group's start-up, the step's collectives and
a launcher for one host."""

from mimo_unet_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    ct_mesh_scope,
    current_ct_mesh,
    make_mesh,
    pad_batch_to_divisible,
    shard_batch,
)
from mimo_unet_torch.parallel.multihost import host_local_batch_slice, initialize_multihost

__all__ = [
    "DATA_AXIS", "Mesh", "ct_mesh_scope", "current_ct_mesh", "make_mesh",
    "pad_batch_to_divisible", "shard_batch", "host_local_batch_slice",
    "initialize_multihost",
]
