"""W half of the bilinear x2 align-corners upsample (K4) and its transpose
(K4b).

Replaces ``mimo_unet_tpu/ops/pallas/ct_resize.py:209`` ``upsample_w2x_ct``:
its forward ``_w2x_fwd_call`` (:222, pallas_call at :237) with
``upsample_w2x`` and its VJP ``_w2x_bwd_call`` (:254, pallas_call at :269;
``_w2x_bwd_rule`` :366) with ``upsample_w2x_bwd``.  ``UpsampleW2x`` is the
``autograd.Function``.  Kernels: ``csrc/upsample_w2x.cu``.

    out[..., j, c] = bf16(x[..., lo_j, c] * w0_j + x[..., lo_j + 1, c] * w1_j)

summed in float32, where ``w0``/``w1`` are the align-corners interpolation
weights rounded to bf16 (``ct_resize.py:228`` casts the matrix to the
activation dtype).  Both products are exact in float32, so the result is
bitwise the TPU kernel's dot.  The transpose contracts the cotangent with
the same bf16 matrix (``ct_resize.py:283``): column K sums full columns
2K-2 .. 2K+2 in that order in float32 and rounds once, which is the W
pass of ``upsample2x_bwd`` (K13).  The H half runs inside the consuming
conv kernel (``x2_half_h``: the eval DoubleConv, K1, and the train conv
forward and dw, K5 and K7).

Both kernels run persistent blocks over the rows at one tile of the
output row's elements (one 16-byte output unit a thread), with stages of
a few rows' input columns and their halo copied into shared memory by
``cp.async``, the next stage in flight while one is computed.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from mimo_unet_torch.kernels import _build
from mimo_unet_torch.ops.resize import _align_corners_tables, _interp_matrix

TAPS = 5  # full rows (columns) that can reach one half-res row (column)


@lru_cache(maxsize=16)
def _tables(w2: int, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """(lo int32, w0, w1) on ``device`` for output width 2*w2; the weights
    are bf16-exact float32.  Cached: a copy to the card per call would
    stall the host."""
    lo, _, frac = _align_corners_tables(w2, 2 * w2)
    w0 = torch.from_numpy(1.0 - frac).to(torch.bfloat16).float()
    w1 = torch.from_numpy(frac).to(torch.bfloat16).float()
    return tuple(t.to(device) for t in (torch.from_numpy(lo), w0, w1))


def _taps(size2: int) -> Tuple[np.ndarray, np.ndarray]:
    """Backward taps of half-res index R: full-res indices 2R-2+t, clipped
    to the image, and whether each lies inside it.  [size2, TAPS] each."""
    idx = 2 * np.arange(size2)[:, None] - 2 + np.arange(TAPS)[None]
    valid = (idx >= 0) & (idx < 2 * size2)
    return np.clip(idx, 0, 2 * size2 - 1), valid


@lru_cache(maxsize=16)
def _w_bwd_weights(w2: int, device: torch.device) -> torch.Tensor:
    """[W2, TAPS] f32: column K's entries of the bf16 interpolation matrix
    at columns 2K-2+u of the full-res row (0 outside the image)."""
    mw = torch.from_numpy(_interp_matrix(w2, 2 * w2)).to(torch.bfloat16).float().numpy()
    cols, valid = _taps(w2)
    wt = np.where(valid, mw[cols, np.arange(w2)[:, None]], np.float32(0))
    return torch.from_numpy(wt.astype(np.float32)).to(device)


def _check_g(g: torch.Tensor) -> None:
    if g.ndim != 4 or g.shape[2] % 2 or g.shape[2] < 4:
        raise ValueError(f"expected [N, H, W, C] with even W >= 4, got "
                         f"{tuple(g.shape)}")


def upsample_w2x_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: [..., W2, C] -> [..., 2*W2, C], same dtype."""
    lo, w0, w1 = _tables(x.shape[-2], x.device)
    lo = lo.long()
    y = (x[..., lo, :].float() * w0[:, None]
         + x[..., lo + 1, :].float() * w1[:, None])
    return y.to(x.dtype)


def upsample_w2x(x: torch.Tensor) -> torch.Tensor:
    """[N, H, W2, C] bf16 -> [N, H, 2*W2, C].  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return upsample_w2x_plain(x)
    _build.require_cuda(x, dtype=torch.bfloat16)
    if x.ndim != 4 or x.shape[2] < 2:
        raise ValueError(f"expected [N, H, W2, C] with W2 >= 2, got {tuple(x.shape)}")
    n, h, w2, c = x.shape
    lo, w0, w1 = _tables(w2, x.device)
    out = torch.empty((n, h, 2 * w2, c), device=x.device, dtype=x.dtype)
    if out.numel() == 0:
        return out
    _build.launch("mimo_upsample_w2x", x.device, x.data_ptr(), lo.data_ptr(),
                  w0.data_ptr(), w1.data_ptr(), out.data_ptr(), n * h, w2, c)
    upsample_w2x.launches += 1
    return out


def upsample_w2x_bwd_plain(g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``upsample_w2x_bwd``."""
    _check_g(g)
    w2 = g.shape[2] // 2
    cols = torch.from_numpy(_taps(w2)[0]).to(g.device)
    ww = _w_bwd_weights(w2, g.device)
    gf = g.float()
    dx = torch.zeros((*g.shape[:2], w2, g.shape[3]), device=g.device)
    for u in range(TAPS):
        dx = dx + gf[:, :, cols[:, u]] * ww[:, u, None]
    return dx.to(g.dtype)


def upsample_w2x_bwd(g: torch.Tensor) -> torch.Tensor:
    """The transpose of ``upsample_w2x`` (K4b): g [N, H, 2*W2, C] bf16 ->
    [N, H, W2, C] bf16.  CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    if g.device.type == "cpu":
        return upsample_w2x_bwd_plain(g)
    _check_g(g)
    _build.require_cuda(g, dtype=torch.bfloat16)
    n, h, w, c = g.shape
    ww = _w_bwd_weights(w // 2, g.device)
    dx = torch.empty((n, h, w // 2, c), device=g.device, dtype=g.dtype)
    if dx.numel() == 0:
        return dx
    _build.launch("mimo_upsample_w2x_bwd", g.device, g.data_ptr(), ww.data_ptr(),
                  dx.data_ptr(), n * h, w // 2, c)
    upsample_w2x_bwd.launches += 1
    return dx


class UpsampleW2x(torch.autograd.Function):
    """y = upsample_w2x(x), backward ``upsample_w2x_bwd``: the W half of
    the x2-half train decoder's upsample."""

    @staticmethod
    def forward(ctx, x):
        return upsample_w2x(x)

    @staticmethod
    def backward(ctx, g):
        return upsample_w2x_bwd(g.contiguous())


upsample_w2x.launches = 0
upsample_w2x_bwd.launches = 0
