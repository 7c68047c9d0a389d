"""The collectives of a data-parallel step: where XLA inserted ``psum``.

The JAX package writes its step as global-batch math and XLA inserts the
reductions (``lax.psum`` under ``shard_map`` on the kernel path,
mimo_unet_tpu/models/fast_path.py:1048-1054).  The port calls them here:

* ``all_reduce_sum``: a sum over ranks whose backward sums the cotangent
  over ranks (the psum's transpose): every BatchNorm site's statistics;
* ``all_gather_rows``: the global batch from every rank's rows (the
  input transform permutes the global batch; under a spatial mesh, over
  the data axis only);
* ``gather_image``: global images from every rank's batch and height
  rows (``parallel/mesh.py`` ``shard_image``'s inverse);
* the halo rows of a spatial mesh (``parallel/halo.py``);
* ``all_reduce``: gradients, logs, validation sums and agreed decisions,
  no autograd; ``sync_gradients`` sums the gradients over ranks in one
  flat buffer a dtype and divides them by the number of ranks;
* ``barrier``.

Only ``all_reduce`` of ``torch.distributed`` is used: gloo takes it on
CUDA tensors, so one code path serves NCCL (a card a rank) and gloo
(ranks sharing a card, or the CPU).  A gather is an
all-reduce of a zero-filled ``[D, ...]`` buffer in which each rank fills
its own row: exact for every value but the sign of a zero.

With no mesh, or a mesh of one rank, every function returns its input
unchanged and calls no collective.  Each call is counted by kind, with its
bytes (``counts``, ``reset_counts``).
"""

from __future__ import annotations

import collections
from typing import Dict, Optional, Tuple

import torch

from mimo_unet_torch.parallel.mesh import (
    AnyMesh,
    Mesh,
    current_ct_mesh,
    image_sharding,
    spans_ranks,
)

_calls: collections.Counter = collections.Counter()
_bytes: collections.Counter = collections.Counter()


def reset_counts() -> None:
    _calls.clear()
    _bytes.clear()


def counts() -> Dict[str, Tuple[int, int]]:
    """kind -> (calls, bytes) since the last ``reset_counts``."""
    return {k: (_calls[k], _bytes[k]) for k in sorted(_calls)}


def _mesh(mesh: Optional[Mesh]) -> Optional[Mesh]:
    return current_ct_mesh() if mesh is None else mesh


def _all_reduce(t: torch.Tensor, mesh: Mesh, kind: str, op: str = "sum") -> None:
    """In place over the mesh's ranks; counted under ``kind``."""
    import torch.distributed as dist

    _calls[kind] += 1
    _bytes[kind] += t.numel() * t.element_size()
    dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op],
                    group=mesh.group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        out = x.contiguous().clone()
        _all_reduce(out, mesh, "stats")
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _all_reduce(g, ctx.mesh, "stats_grad")
        return g, None


def all_reduce_sum(x: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``mesh`` (the active mesh when None),
    differentiable: the backward sums the cotangent over the ranks."""
    mesh = _mesh(mesh)
    if not spans_ranks(mesh):
        return x
    return _AllReduceSum.apply(x, mesh)


def all_reduce(x: torch.Tensor, mesh: Optional[Mesh] = None, kind: str = "all_reduce",
               op: str = "sum") -> torch.Tensor:
    """``op`` ("sum" or "max") of ``x`` over the ranks, a new tensor; no
    autograd.  Counted under ``kind``."""
    mesh = _mesh(mesh)
    if not spans_ranks(mesh):
        return x
    out = x.detach().contiguous().clone()
    _all_reduce(out, mesh, kind, op)
    return out


def all_gather_rows(x: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Every rank's ``x`` [b, ...] joined rank-major into [D*b, ...], on each
    rank: an all-reduce of a zero-filled [D, b, ...] buffer holding this
    rank's rows in its own slot.  No autograd."""
    mesh = _mesh(mesh)
    if not spans_ranks(mesh):
        return x
    src = x.detach()
    as_bool = src.dtype == torch.bool
    if as_bool:
        src = src.view(torch.uint8)
    buf = torch.zeros((mesh.size,) + tuple(src.shape), dtype=src.dtype,
                      device=src.device)
    buf[mesh.rank] = src
    _all_reduce(buf, mesh, "rows")
    out = buf.view((mesh.size * src.shape[0],) + tuple(src.shape[1:]))
    return out.view(torch.bool) if as_bool else out


def gather_image(y: torch.Tensor, mesh: Optional[AnyMesh] = None, rank: int = 5
                 ) -> torch.Tensor:
    """The global image tensor of rank ``rank`` from every rank's part as
    ``image_sharding(mesh, rank)`` lays them out, on each rank: an
    all-reduce of a zero-filled [data, spatial, ...] buffer holding this
    rank's part in its own slot.  ``all_gather_rows`` on a mesh without a
    spatial axis.  No autograd."""
    mesh = _mesh(mesh)
    h_axis = image_sharding(mesh, rank).h_axis if mesh is not None else None
    if h_axis is None:
        return all_gather_rows(y, mesh)
    src = y.detach()
    buf = torch.zeros((mesh.data, mesh.spatial) + tuple(src.shape), dtype=src.dtype,
                      device=src.device)
    buf[mesh.data_index, mesh.spatial_index] = src
    if spans_ranks(mesh):
        _all_reduce(buf, mesh, "image")
    # [d, s, b, ..., h, ...] -> [d, b, ..., s, h, ...] -> [d*b, ..., s*h, ...]
    dims = list(range(2, 2 + src.ndim))
    buf = buf.permute([0, dims[0]] + dims[1:h_axis] + [1] + dims[h_axis:])
    shape = list(src.shape)
    shape[0] *= mesh.data
    shape[h_axis] *= mesh.spatial
    return buf.reshape(shape)


def barrier(mesh: Optional[Mesh] = None) -> None:
    """Return once every rank has come here (an all-reduce of one element
    on the mesh's device)."""
    mesh = _mesh(mesh)
    if spans_ranks(mesh):
        _all_reduce(torch.zeros(1, device=mesh.device), mesh, "barrier")


def agree_max(value: int, mesh: Optional[Mesh] = None) -> int:
    """The largest of the ranks' ``value``: how ranks agree on a decision
    that depends on what each saw (a remat rung, whether a cache fits)."""
    mesh = _mesh(mesh)
    if not spans_ranks(mesh):
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=mesh.device)
    return int(all_reduce(t, mesh, "decision", op="max").item())


def sync_gradients(parameters, mesh: Optional[Mesh] = None) -> None:
    """Replace every gradient by its mean over the ranks: one flat buffer a
    dtype, in the parameters' order, summed over the ranks and divided by
    their number once.  Every rank ends with the same bits, so the same
    optimizer step keeps the parameters equal on every rank."""
    mesh = _mesh(mesh)
    if not spans_ranks(mesh):
        return
    by_dtype: Dict[torch.dtype, list] = {}
    for p in parameters:
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        _all_reduce(flat, mesh, "grads")
        flat /= mesh.size
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
