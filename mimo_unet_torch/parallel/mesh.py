"""1-D data-parallel mesh over ``torch.distributed`` ranks.

Counterpart of ``mimo_unet_tpu/parallel/mesh.py``.  The JAX package
shards the batch axis of one program over the chips of a
``jax.sharding.Mesh`` and lets XLA insert the collectives; the port runs
one process a card (a rank of a ``torch.distributed`` process group), each
holding the whole model and its rows of the global batch, and calls the
collectives where XLA inserted them (``parallel/collectives.py``): the
BatchNorm statistics of every train site, their cotangents, the gradients,
the input transform's rows and the logs.  A step over D ranks computes
what one device computes on the global batch, as in the JAX package
(:1-14).

What takes the place of the JAX placement specs, which have no torch
object: ``batch_sharding`` is each rank holding its own rows of a global
batch (``shard_batch``, ``Mesh.rows``, ``host_local_batch_slice``);
``replicated_sharding`` is every rank holding the whole model, kept equal
bit for bit by summing the gradients over the ranks before each optimizer
step (``collectives.sync_gradients``).

Not ported yet: ``make_mesh_2d`` and ``image_sharding``, the spatial H
split (ROADMAP).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a 1-D data mesh: the process group (None for one
    process without one), this rank, the number of ranks and this rank's
    device."""

    group: object
    rank: int
    size: int
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.size}

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that logs and writes checkpoints."""
        return self.rank == 0

    def rows(self, global_batch: int) -> Tuple[int, int]:
        """[start, stop) of this rank's rows of a global batch."""
        if global_batch % self.size:
            raise ValueError(f"global batch {global_batch} must be divisible by "
                             f"the mesh size {self.size}")
        per = global_batch // self.size
        return self.rank * per, (self.rank + 1) * per


def rank_count(mesh: Optional[Mesh]) -> int:
    """The ranks a step over ``mesh`` spans: its size, 1 without a mesh."""
    return 1 if mesh is None else mesh.size


def local_slice(mesh: Optional[Mesh], global_batch: int) -> slice:
    """This rank's rows of a global batch: all of them without a mesh."""
    return slice(None) if mesh is None else slice(*mesh.rows(global_batch))


def spans_ranks(mesh: Optional[Mesh]) -> bool:
    """True when ``mesh`` has more than one rank: only then does a step
    call collectives."""
    return rank_count(mesh) > 1


# --------------------------------------------------------------------------
# The active mesh.  The model's forward cannot see the trainer's mesh, so
# the trainer (and any other mesh-owning caller) publishes it here for the
# duration of its steps; the BatchNorm sites (models/fast_path.py
# ``_conv_bn``, ops/norm.py ``batch_norm_train``) and the tasks' steps read
# it as they run (mimo_unet_tpu/parallel/mesh.py:30-61).

_CT_MESH_STACK: list = []


@contextlib.contextmanager
def ct_mesh_scope(mesh: Optional[Mesh]):
    """Publish ``mesh`` to the steps and BatchNorm sites run inside.
    ``None`` (also inside another scope) or a mesh of one rank runs them
    without collectives."""
    _CT_MESH_STACK.append(mesh)
    try:
        yield
    finally:
        _CT_MESH_STACK.pop()


def current_ct_mesh() -> Optional[Mesh]:
    """The innermost active ``ct_mesh_scope`` mesh, or None."""
    return _CT_MESH_STACK[-1] if _CT_MESH_STACK else None


def rank_device(device=None) -> torch.device:
    """This rank's device: the CPU when ``device`` is a CPU device; a card
    given with its index as it is; else ``cuda:LOCAL_RANK`` where every rank
    of this host has a card of its own, and the one card they share where
    there are fewer cards than ranks (those ranks need the gloo backend:
    NCCL refuses two ranks on one device)."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    import torch.distributed as dist

    init = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if init else 1
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if init else 0))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if torch.cuda.device_count() >= local_world:
        return torch.device("cuda", local)
    return torch.device("cuda", 0)


def make_mesh(num_devices: Optional[int] = None, device=None) -> Mesh:
    """A 1-D data mesh over the first ``num_devices`` ranks of the process
    group (all of them when None), as the JAX function takes
    ``devices[:num_devices]`` (:64-70).  Without a process group only a
    mesh of one is possible: ``num_devices`` > 1 then raises, naming how to
    start the ranks.  Every rank of the group must call this (a mesh of
    fewer ranks makes a new group); a rank outside the first
    ``num_devices`` raises."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        if (num_devices or 1) > 1:
            raise ValueError(
                f"a mesh of {num_devices} ranks needs {num_devices} processes in "
                f"a process group: start them with torchrun, with "
                f"mimo_unet_torch.parallel.launch.spawn, or with "
                f"parallel.multihost.initialize_multihost in each")
        from mimo_unet_torch.models.mimo_unet import resolve_device

        return Mesh(None, 0, 1, resolve_device(device))
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if num_devices is None else int(num_devices)
    if not 1 <= n <= world:
        raise ValueError(f"num_devices={num_devices}: the process group has "
                         f"{world} ranks")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    if rank >= n:
        raise ValueError(f"rank {rank} is outside the mesh of the first {n} "
                         f"ranks; start {n} ranks")
    return Mesh(group, rank, n, rank_device(device))


def shard_batch(batch: Dict[str, np.ndarray], mesh: Mesh
                ) -> Dict[str, torch.Tensor]:
    """This rank's rows of a host batch dict, on its device (None entries
    dropped): the role of placing a batch with ``batch_sharding``."""
    start, stop = mesh.rows(len(next(iter(batch.values()))))
    return {k: torch.as_tensor(np.ascontiguousarray(v[start:stop])).to(mesh.device)
            for k, v in batch.items() if v is not None}


def pad_batch_to_divisible(batch: Dict[str, np.ndarray], n: int):
    """Pad the batch dim up to a multiple of ``n`` by repeating the last row
    (uneven final val batches under data parallelism).  Returns
    (padded_batch, real_count)."""
    b = len(next(iter(batch.values())))
    rem = (-b) % n
    if rem == 0:
        return batch, b
    out = {}
    for k, v in batch.items():
        pad = np.repeat(v[-1:], rem, axis=0)
        out[k] = np.concatenate([v, pad], axis=0)
    return out, b
