"""Bilinear x2 upsample with align_corners=True of channels-last bf16
activations, and its transpose (K13); the transpose of its H lerp alone
(K14).

Replaces ``mimo_unet_tpu/ops/pallas/ct_resize.py:54`` ``upsample2x_ct``:
the forward ``_up2_fwd_call`` (:59, pallas_call at :105) and the backward
``_up2_bwd_call`` (:124, pallas_call at :176); and ``ct_resize.py:295``
``lerp_h2x_transpose_ct`` (pallas_call at :345) with
``lerp_h2x_transpose``, the backward of the H lerp that the x2-half train
decoder stages inside its conv kernels.  Kernel: ``csrc/upsample2x.cu``.
``Upsample2x`` is the ``autograd.Function``.

Rounding points (both versions; the TPU kernel's, not those of
``ops/resize.py``, which goes H first):

  forward   W first: s = bf16(x[lo] * w0 + x[lo + 1] * w1) with the
            interpolation matrix rounded to bf16 (two exact products, one
            rounding); then the H lerp in f32, y = bf16(s[lo] * (1 - f) +
            s[lo + 1] * f), f from the TPU kernel's integer row arithmetic,
            float32(r*(h2-1) - lo*(h-1)) / (h-1), as XLA compiles it: the
            division by the constant h-1 becomes a multiply by its f32
            reciprocal (one f32 ulp from the quotient at some rows)
  backward  the H transpose in f32 with the same weights over the five
            full rows 2R-2 .. 2R+2 that can reach half row R, summed in
            that order and rounded to bf16 (``lerp_h2x_transpose``); then
            the W transpose against the bf16 matrix over columns
            2K-2 .. 2K+2, summed in f32 in that order and rounded to bf16
            (``upsample_w2x_bwd``, K4b): the two in turn are this
            backward bit for bit

H2 and W2 must be at least 2; nothing else is required of the shape.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from mimo_unet_torch.kernels import _build
from mimo_unet_torch.kernels.upsample_w2x import (
    TAPS,
    _taps,
    _w_bwd_weights,
    _tables as _w_fwd_tables,
    upsample_w2x_bwd_plain,
)

BF16 = torch.bfloat16


@lru_cache(maxsize=16)
def _h_tables(h2: int, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """(lo int32 [H], 1 - f [H], f [H], backward weights [H2, TAPS]) on
    ``device``, all f32 computed as the TPU kernel computes them (its
    ``/ float(h - 1)`` compiled as a multiply by the reciprocal)."""
    h = 2 * h2
    num = np.arange(h) * (h2 - 1)
    lo = np.minimum(num // (h - 1), h2 - 2)
    f = (num - lo * (h - 1)).astype(np.float32) * (np.float32(1) / np.float32(h - 1))
    fa = np.float32(1.0) - f
    rows, valid = _taps(h2)
    half = np.arange(h2)[:, None]
    wt = np.where(lo[rows] == half, fa[rows],
                  np.where(lo[rows] + 1 == half, f[rows], np.float32(0)))
    wt = np.where(valid, wt, np.float32(0)).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(t)).to(device)
                 for t in (lo.astype(np.int32), fa, f, wt))


def _check(x: torch.Tensor) -> None:
    if x.ndim != 4 or x.shape[1] < 2 or x.shape[2] < 2:
        raise ValueError(f"expected [N, H2, W2, C] with H2, W2 >= 2, got "
                         f"{tuple(x.shape)}")


def _check_g(g: torch.Tensor) -> None:
    if g.ndim != 4 or g.shape[1] % 2 or g.shape[2] % 2 or min(g.shape[1:3]) < 4:
        raise ValueError(f"expected [N, H, W, C] with even H, W >= 4, got "
                         f"{tuple(g.shape)}")


def _check_gh(g: torch.Tensor) -> None:
    if g.ndim != 4 or g.shape[1] % 2 or g.shape[1] < 4:
        raise ValueError(f"expected [N, H, W, C] with even H >= 4, got "
                         f"{tuple(g.shape)}")


def upsample2x_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: [N, H2, W2, C] -> [N, 2*H2, 2*W2, C]."""
    _check(x)
    lo_w, w0, w1 = _w_fwd_tables(x.shape[2], x.device)
    lo_w = lo_w.long()
    xf = x.float()
    s = (xf[:, :, lo_w] * w0[:, None] + xf[:, :, lo_w + 1] * w1[:, None])
    s = s.to(BF16).float()
    lo_h, fa, fb, _ = _h_tables(x.shape[1], x.device)
    lo_h = lo_h.long()
    y = s[:, lo_h] * fa[:, None, None] + s[:, lo_h + 1] * fb[:, None, None]
    return y.to(x.dtype)


def lerp_h2x_transpose_plain(g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``lerp_h2x_transpose``."""
    _check_gh(g)
    h2 = g.shape[1] // 2
    rows = torch.from_numpy(_taps(h2)[0]).to(g.device)
    wh = _h_tables(h2, g.device)[3]
    gf = g.float()
    acc = torch.zeros((g.shape[0], h2, *g.shape[2:]), device=g.device)
    for t in range(TAPS):
        acc = acc + gf[:, rows[:, t]] * wh[:, t, None, None]
    return acc.to(g.dtype)


def upsample2x_bwd_plain(g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``upsample2x_bwd``: the H transpose, then
    the W transpose."""
    _check_g(g)
    return upsample_w2x_bwd_plain(lerp_h2x_transpose_plain(g))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """[N, H2, W2, C] bf16 -> [N, 2*H2, 2*W2, C].  CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return upsample2x_plain(x)
    _check(x)
    _build.require_cuda(x, dtype=BF16)
    n, h2, w2, c = x.shape
    lo_w, w0, w1 = _w_fwd_tables(w2, x.device)
    lo_h, fa, fb, _ = _h_tables(h2, x.device)
    y = torch.empty((n, 2 * h2, 2 * w2, c), device=x.device, dtype=BF16)
    if y.numel() == 0:
        return y
    _build.launch("mimo_upsample2x", x.device, x.data_ptr(), lo_w.data_ptr(),
                  w0.data_ptr(), w1.data_ptr(), lo_h.data_ptr(), fa.data_ptr(),
                  fb.data_ptr(), y.data_ptr(), n, h2, w2, c)
    upsample2x.launches += 1
    return y


def upsample2x_bwd(g: torch.Tensor) -> torch.Tensor:
    """The transpose of ``upsample2x``: g [N, H, W, C] bf16 -> [N, H/2,
    W/2, C] bf16.  CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    if g.device.type == "cpu":
        return upsample2x_bwd_plain(g)
    _check_g(g)
    _build.require_cuda(g, dtype=BF16)
    n, h, w, c = g.shape
    wh = _h_tables(h // 2, g.device)[3]
    ww = _w_bwd_weights(w // 2, g.device)
    dx = torch.empty((n, h // 2, w // 2, c), device=g.device, dtype=BF16)
    if dx.numel() == 0:
        return dx
    _build.launch("mimo_upsample2x_bwd", g.device, g.data_ptr(), wh.data_ptr(),
                  ww.data_ptr(), dx.data_ptr(), n, h // 2, w // 2, c)
    upsample2x_bwd.launches += 1
    return dx


def lerp_h2x_transpose(g: torch.Tensor) -> torch.Tensor:
    """The transpose of the H row lerp alone (K14): g [N, H, W, C] bf16 ->
    [N, H/2, W, C] bf16, W the full width (the x2-half decoder's W
    transpose is ``upsample_w2x_bwd``).  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if g.device.type == "cpu":
        return lerp_h2x_transpose_plain(g)
    _check_gh(g)
    _build.require_cuda(g, dtype=BF16)
    n, h, w, c = g.shape
    wh = _h_tables(h // 2, g.device)[3]
    dx = torch.empty((n, h // 2, w, c), device=g.device, dtype=BF16)
    if dx.numel() == 0:
        return dx
    _build.launch("mimo_lerp_h2x_transpose", g.device, g.data_ptr(),
                  wh.data_ptr(), dx.data_ptr(), n, h // 2, w, c)
    lerp_h2x_transpose.launches += 1
    return dx


class Upsample2x(torch.autograd.Function):
    """y = upsample2x(x), backward ``upsample2x_bwd``."""

    @staticmethod
    def forward(ctx, x):
        return upsample2x(x)

    @staticmethod
    def backward(ctx, g):
        return upsample2x_bwd(g.contiguous())


upsample2x.launches = 0
upsample2x_bwd.launches = 0
lerp_h2x_transpose.launches = 0
