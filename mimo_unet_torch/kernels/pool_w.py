"""W-pair max: the W half of a 2x2 max pool whose H half a DoubleConv kernel
emitted (``emit_hpool``).

Replaces ``mimo_unet_tpu/ops/pallas/ct_elem.py:193`` ``max_pool_w_ct``
(pallas_call at :232).  Kernel: ``csrc/pool_w.cu``.

    out[n, r, j, c] = max(x[n, r, 2j, c], x[n, r, 2j + 1, c])

bitwise, on channels-last bf16 ``[..., W, C]`` -> ``[..., W // 2, C]``.
"""

from __future__ import annotations

import torch

from mimo_unet_torch.kernels import _build


def pool_w_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: [..., W, C] -> [..., W // 2, C]."""
    return torch.maximum(x[..., 0::2, :], x[..., 1::2, :])


def pool_w(x: torch.Tensor) -> torch.Tensor:
    """[N, H, W, C] bf16 -> [N, H, W // 2, C].  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return pool_w_plain(x)
    _build.require_cuda(x, dtype=torch.bfloat16)
    if x.ndim != 4 or x.shape[2] % 2:
        raise ValueError(f"expected [N, H, W, C] with even W, got {tuple(x.shape)}")
    n, h, w, c = x.shape
    out = torch.empty((n, h, w // 2, c), device=x.device, dtype=x.dtype)
    if out.numel() == 0:
        return out
    _build.launch("mimo_pool_w", x.device, x.data_ptr(), out.data_ptr(),
                  n * h, w, c)
    pool_w.launches += 1
    return out


pool_w.launches = 0
