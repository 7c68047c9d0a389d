"""W half of the bilinear x2 align-corners upsample.

Replaces the forward of ``mimo_unet_tpu/ops/pallas/ct_resize.py:209``
``upsample_w2x_ct`` (``_w2x_fwd_call`` :222, pallas_call at :237); its
backward comes with the train path.  Kernel: ``csrc/upsample_w2x.cu``.

    out[..., j, c] = bf16(x[..., lo_j, c] * w0_j + x[..., lo_j + 1, c] * w1_j)

summed in float32, where ``w0``/``w1`` are the align-corners interpolation
weights rounded to bf16 (``ct_resize.py:228`` casts the matrix to the
activation dtype).  Both products are exact in float32, so the result is
bitwise the TPU kernel's dot.  The H half runs inside the consuming
DoubleConv kernel (``x2_half_h``).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import torch

from mimo_unet_torch.kernels import _build
from mimo_unet_torch.ops.resize import _align_corners_tables


@lru_cache(maxsize=16)
def _tables(w2: int, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """(lo int32, w0, w1) on ``device`` for output width 2*w2; the weights
    are bf16-exact float32.  Cached: a copy to the card per call would
    stall the host."""
    lo, _, frac = _align_corners_tables(w2, 2 * w2)
    w0 = torch.from_numpy(1.0 - frac).to(torch.bfloat16).float()
    w1 = torch.from_numpy(frac).to(torch.bfloat16).float()
    return tuple(t.to(device) for t in (torch.from_numpy(lo), w0, w1))


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


upsample_w2x.launches = 0
