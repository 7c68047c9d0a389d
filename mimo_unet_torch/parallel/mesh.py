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

The spatial (H) split, ``make_mesh_2d`` and ``image_sharding`` (:73-113):
a ``Mesh2D`` of data x spatial ranks, laid out data-major, in which each
rank holds its rows of the global batch and its rows of every image's
height.  Where XLA's partitioner inserts the halo exchanges of every 3x3
conv and x2 upsample, the port calls ``parallel/halo.py`` from the plain
ops (``ops/conv.py``, ``ops/resize.py``); the pools need none, as every
shard holds an even number of rows at every level (``check_spatial_height``:
H a multiple of 16 x spatial).  BatchNorm, the loss, the gradients, the
logs and the metrics are summed over the whole mesh, the input transform
gathers over the data group only.  ``image_sharding`` is a spec of axis
names (no torch placement object); ``shard_image`` and ``gather_image``
place and join image tensors.  The hand-written kernels stand aside under
a spatial mesh (``models/fast_path.py``), as the JAX package's do.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"


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


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """This rank's view of a data x spatial mesh (``make_mesh_2d``): the
    process group of the whole mesh (None for a mesh of one), this rank
    in it, the axes' sizes, this rank's device, and the groups of its data
    axis (the ranks of its spatial index) and of its spatial axis (the
    ranks of its data index).  Ranks are laid out data-major: rank
    ``data_index * spatial + spatial_index``.  ``group``, ``rank`` and
    ``size`` are the whole mesh's, so the collectives that sum over every
    rank (BatchNorm, gradients, logs, metrics) take it as they take a
    ``Mesh``."""

    group: object
    rank: int
    data: int
    spatial: int
    device: torch.device
    data_group: object
    spatial_group: object

    @property
    def size(self) -> int:
        return self.data * self.spatial

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, SPATIAL_AXIS: self.spatial}

    @property
    def data_index(self) -> int:
        return self.rank // self.spatial

    @property
    def spatial_index(self) -> int:
        return self.rank % self.spatial

    @property
    def data_mesh(self) -> Mesh:
        """The data axis through this rank: the ranks of its spatial index."""
        return Mesh(self.data_group, self.data_index, self.data, self.device)

    @property
    def spatial_mesh(self) -> Mesh:
        """The spatial axis through this rank: the ranks of its data index,
        which hold the same batch rows and split their height."""
        return Mesh(self.spatial_group, self.spatial_index, self.spatial, self.device)

    def rows(self, global_batch: int) -> Tuple[int, int]:
        """[start, stop) of this rank's rows of a global batch: its data
        index's."""
        return self.data_mesh.rows(global_batch)

    def h_rows(self, global_h: int) -> Tuple[int, int]:
        """[start, stop) of this rank's rows of an image height."""
        check_spatial_height(global_h, self, levels=0)
        per = global_h // self.spatial
        return self.spatial_index * per, (self.spatial_index + 1) * per


AnyMesh = Union[Mesh, Mesh2D]


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


def data_mesh(mesh: Optional[AnyMesh]) -> Optional[Mesh]:
    """The data axis of ``mesh`` through this rank: a 1-D mesh as it is."""
    return mesh.data_mesh if isinstance(mesh, Mesh2D) else mesh


def spatial_mesh(mesh: Optional[AnyMesh]) -> Optional[Mesh]:
    """The spatial axis of ``mesh`` through this rank; None for a 1-D mesh
    or none."""
    return mesh.spatial_mesh if isinstance(mesh, Mesh2D) else None


def spatial_count(mesh: Optional[AnyMesh]) -> int:
    """The ranks that split an image's height: 1 without a spatial axis."""
    return mesh.spatial if isinstance(mesh, Mesh2D) else 1


def data_index(mesh: Optional[AnyMesh]) -> int:
    """This rank's index on the data axis (0 without a mesh): what keys its
    dropout masks, so spatial peers draw the same ones."""
    if mesh is None:
        return 0
    return mesh.data_index if isinstance(mesh, Mesh2D) else mesh.rank


# the pools a forward takes: down1 and the core's down2-down4
POOL_LEVELS = 4


def check_spatial_height(global_h: int, mesh: Optional[AnyMesh],
                         levels: int = POOL_LEVELS) -> None:
    """Raise ``ValueError`` unless every shard of a height ``global_h``
    split over ``mesh``'s spatial axis holds an even number of rows at
    each of ``levels`` pools: H a multiple of spatial x 2**levels (16 for
    the U-Net).  The pools then need no halo and pad-to-match never pads
    H."""
    k = spatial_count(mesh)
    if k > 1 and global_h % (k << levels):
        raise ValueError(
            f"height {global_h} cannot be split over {k} spatial ranks: under a "
            f"spatial mesh H must be a multiple of spatial * {1 << levels} = "
            f"{k << levels}")


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


def make_mesh_2d(data: int, spatial: int, device=None) -> Mesh2D:
    """A data x spatial mesh over the first ``data * spatial`` ranks of the
    process group, laid out data-major as the JAX function reshapes its
    devices (:88-113).  Raises ``ValueError`` where the mesh needs more
    ranks than the group has (without a group, more than one).  Every rank
    of the group must call this: it makes the groups of every data and
    spatial axis; a rank outside the mesh then raises."""
    import torch.distributed as dist

    n = int(data) * int(spatial)
    if data < 1 or spatial < 1:
        raise ValueError(f"mesh {data}x{spatial}: both axes need at least one rank")
    if not (dist.is_available() and dist.is_initialized()):
        if n > 1:
            raise ValueError(
                f"mesh {data}x{spatial} needs {n} devices (ranks), have 1: start "
                f"{n} processes in a process group (torchrun, "
                f"mimo_unet_torch.parallel.launch.spawn or "
                f"parallel.multihost.initialize_multihost)")
        from mimo_unet_torch.models.mimo_unet import resolve_device

        return Mesh2D(None, 0, 1, 1, resolve_device(device), None, None)
    world, rank = dist.get_world_size(), dist.get_rank()
    if n > world:
        raise ValueError(f"mesh {data}x{spatial} needs {n} devices (ranks), have {world}")
    whole = list(range(n))

    def group(ranks):
        # every rank makes every group, in one order; a group of one needs
        # no collective and the whole mesh's is made once
        if len(ranks) == 1:
            return None
        if ranks == whole:
            return mesh_group
        return dist.new_group(ranks)

    mesh_group = dist.group.WORLD if n == world else dist.new_group(whole)
    data_groups = [group([d * spatial + s for d in range(data)]) for s in range(spatial)]
    spatial_groups = [group([d * spatial + s for s in range(spatial)]) for d in range(data)]
    if rank >= n:
        raise ValueError(f"rank {rank} is outside the {data}x{spatial} mesh of the "
                         f"first {n} ranks; start {n} ranks")
    return Mesh2D(mesh_group, rank, int(data), int(spatial), rank_device(device),
                  data_groups[rank % spatial], spatial_groups[rank // spatial])


@dataclasses.dataclass(frozen=True)
class ImageSharding:
    """Where image activations lie on a mesh: ``spec`` names the mesh axis
    of each tensor axis (None: not split), as the JAX
    ``PartitionSpec`` does; trailing axes are not split."""

    spec: Tuple[Optional[str], ...]

    @property
    def h_axis(self) -> Optional[int]:
        """The tensor axis split over the spatial axis, or None."""
        return self.spec.index(SPATIAL_AXIS) if SPATIAL_AXIS in self.spec else None


def image_sharding(mesh: AnyMesh, rank: int = 5) -> ImageSharding:
    """Batch on "data", image height on "spatial" (:97-113): rank 5 for the
    MIMO [B, S, H, W, C] tensors (H is axis 2), rank 4 for [B, H, W, C]
    (H is axis 1); the batch alone on a mesh without a spatial axis.  The
    rank is explicit, since the wrong one would split W instead of H."""
    if rank not in (4, 5):
        raise ValueError(f"image_sharding supports rank 4 or 5, got {rank}")
    if not isinstance(mesh, Mesh2D):
        return ImageSharding((DATA_AXIS,))
    if rank == 4:
        return ImageSharding((DATA_AXIS, SPATIAL_AXIS))
    return ImageSharding((DATA_AXIS, None, SPATIAL_AXIS))


def shard_image(x, mesh: AnyMesh, rank: int = 5) -> torch.Tensor:
    """This rank's batch rows and height rows (``image_sharding(mesh,
    rank)``) of a global image array or tensor of ``rank`` axes, on the
    mesh's device."""
    if x.ndim != rank:
        raise ValueError(f"expected a rank-{rank} image tensor, got shape {tuple(x.shape)}")
    sharding = image_sharding(mesh, rank)
    index = [slice(*mesh.rows(x.shape[0]))] + [slice(None)] * (rank - 1)
    if sharding.h_axis is not None:
        index[sharding.h_axis] = slice(*mesh.h_rows(x.shape[sharding.h_axis]))
    part = x[tuple(index)]
    if isinstance(part, np.ndarray):
        part = torch.from_numpy(np.ascontiguousarray(part))
    return part.contiguous().to(mesh.device)


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
