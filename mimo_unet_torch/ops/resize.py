"""Bilinear x2 upsampling with align_corners=True, and pad-to-match (NCHW).

Counterpart of ``mimo_unet_tpu/ops/resize.py``.  The reference ``Up`` block
(mimo/models/mimo_components/components.py:78,106-119) upsamples with
``nn.Upsample(scale_factor=2, mode="bilinear", align_corners=True)``, then
zero-pads to the skip tensor's size.

The resize contracts H and W against the dense align-corners interpolation
matrices (<= 2 nonzeros per row), one axis at a time, with the matrices in
the activation dtype.  In float32 that is exact; in bfloat16 the weights
round to bf16 and the H pass rounds to bf16 before the W pass, the same
rounding points as the JAX package's bf16 path.  Gradients come from
autograd through the contractions.

Under a spatial mesh (``parallel/mesh.py`` ``Mesh2D``) each rank holds its
rows of the height: the H pass contracts the shard's input rows and one
neighbour row each side (``parallel/halo.py``) against the global
matrix's rows of the shard's output rows.  Align-corners maps output row
``o`` to ``o * (H - 1) / (2H - 1)``, which lies less than one row outside
the shard's input rows, so one halo row each side suffices.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from mimo_unet_torch.parallel.halo import halo_rows
from mimo_unet_torch.parallel.mesh import current_ct_mesh, spans_ranks, spatial_mesh


def _align_corners_tables(in_size: int, out_size: int):
    """Static (lo_idx, hi_idx, frac) tables for 1D align-corners resize."""
    if in_size == 1:
        lo = np.zeros(out_size, dtype=np.int32)
        return lo, lo, np.zeros(out_size, dtype=np.float32)
    src = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    lo = np.floor(src).astype(np.int32)
    lo = np.clip(lo, 0, in_size - 2)
    frac = (src - lo).astype(np.float32)
    return lo, lo + 1, frac


def _interp_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense [out, in] align-corners interpolation matrix (<=2 nonzeros/row)."""
    lo, hi, frac = _align_corners_tables(in_size, out_size)
    mat = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    np.add.at(mat, (rows, lo), 1.0 - frac)
    np.add.at(mat, (rows, hi), frac)
    return mat


def shard_interp_matrix(h: int, index: int, count: int) -> np.ndarray:
    """The H matrix of shard ``index`` of ``count``, each of ``h`` input
    rows: the global [2H, H] matrix's rows of the shard's 2h output rows,
    its columns those of the global input rows ``index * h - 1`` to
    ``(index + 1) * h`` (the shard and its halo rows; a column past the
    global edge is zero).  [2h, h + 2]."""
    full = np.pad(_interp_matrix(h * count, 2 * h * count), ((0, 0), (1, 1)))
    return full[2 * h * index:2 * h * (index + 1), h * index:h * (index + 1) + 2]


def upsample_bilinear_x2_align_corners(x: torch.Tensor) -> torch.Tensor:
    """NCHW x2 bilinear upsample, align_corners=True (torch semantics)."""
    h, w = x.shape[-2], x.shape[-1]
    mesh = spatial_mesh(current_ct_mesh())
    if spans_ranks(mesh):
        mh = shard_interp_matrix(h, mesh.rank, mesh.size)
        x = halo_rows(x, mesh)
    else:
        mh = _interp_matrix(h, 2 * h)
    mh = torch.from_numpy(mh).to(x.device, x.dtype)
    mw = torch.from_numpy(_interp_matrix(w, 2 * w)).to(x.device, x.dtype)
    y = torch.einsum("oh,nchw->ncow", mh, x)
    return torch.einsum("pw,ncow->ncop", mw, y)


def pad_to_match(x: torch.Tensor, target_h: int, target_w: int) -> torch.Tensor:
    """Zero-pad NCHW spatial dims to (target_h, target_w), torch F.pad split
    (reference components.py:112-115)."""
    dy = target_h - x.shape[-2]
    dx = target_w - x.shape[-1]
    if dy == 0 and dx == 0:
        return x
    return F.pad(x, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))
