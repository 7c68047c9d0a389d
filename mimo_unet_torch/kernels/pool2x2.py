"""2x2 / stride-2 max pool of channels-last bf16 activations, and its
backward with the skip branch's cotangent fused in (K10).

Replaces ``mimo_unet_tpu/ops/pallas/ct_elem.py:282`` ``max_pool2x2_ct``
(pallas_call at :314), its backward ``_pool_bwd_call`` (:336, pallas_call
at :384) and ``:411`` ``max_pool2x2_skip_ct``.  Kernel: ``csrc/pool2x2.cu``.

    max_pool2x2      [N, H, W, C] -> [N, H/2, W/2, C], the max of each 2x2
                     window, bitwise
    max_pool2x2_bwd  gx = bf16(where(x == up(y), up(g), 0) + g_skip),
                     computed in f32 and rounded once; every tied element
                     of a window gets the gradient (the JAX package's
                     rule, ``ops/pooling.py:28-30``)

``MaxPool2x2Skip`` returns ``(pooled, identity)`` for a tensor that feeds
both a pool and a skip connection: the identity's cotangent streams into
the pool's backward pass, so the full-resolution add never runs as a pass
of its own.  ``MaxPool2x2`` is the pool alone.  H and W must be even;
nothing else is required of the shape.
"""

from __future__ import annotations

from typing import Optional

import torch

from mimo_unet_torch.kernels import _build

BF16 = torch.bfloat16


def _check(x: torch.Tensor) -> None:
    if x.ndim != 4 or x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"expected [N, H, W, C] with even H and W, got "
                         f"{tuple(x.shape)}")


def _up(t: torch.Tensor) -> torch.Tensor:
    """[N, H/2, W/2, C] -> [N, H, W, C], each value copied to its window."""
    return t.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def max_pool2x2_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the window max in f32, cast back (exact)."""
    _check(x)
    n, h, w, c = x.shape
    xf = x.float().view(n, h // 2, 2, w // 2, 2, c)
    return xf.amax(dim=(2, 4)).to(x.dtype)


def max_pool2x2_bwd_plain(g: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                          g_skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of ``max_pool2x2_bwd``, in f32."""
    v = torch.where(x.float() == _up(y.float()), _up(g.float()),
                    torch.zeros((), device=x.device))
    if g_skip is not None:
        v = v + g_skip.float()
    return v.to(x.dtype)


def max_pool2x2(x: torch.Tensor) -> torch.Tensor:
    """[N, H, W, C] bf16 -> [N, H/2, W/2, C].  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return max_pool2x2_plain(x)
    _check(x)
    _build.require_cuda(x, dtype=BF16)
    n, h, w, c = x.shape
    y = torch.empty((n, h // 2, w // 2, c), device=x.device, dtype=BF16)
    if y.numel() == 0:
        return y
    _build.launch("mimo_pool2x2", x.device, x.data_ptr(), y.data_ptr(), n, h, w, c)
    max_pool2x2.launches += 1
    return y


def max_pool2x2_bwd(g: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    g_skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """g, y [N, H/2, W/2, C]; x, g_skip [N, H, W, C]; all bf16 -> gx
    [N, H, W, C] bf16.  CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    _check(x)
    n, h, w, c = x.shape
    half = (n, h // 2, w // 2, c)
    if tuple(g.shape) != half or tuple(y.shape) != half:
        raise ValueError(f"g and y must be {half}, got {tuple(g.shape)}, "
                         f"{tuple(y.shape)}")
    if g_skip is not None and g_skip.shape != x.shape:
        raise ValueError(f"g_skip must be {tuple(x.shape)}, got "
                         f"{tuple(g_skip.shape)}")
    if x.device.type == "cpu":
        return max_pool2x2_bwd_plain(g, x, y, g_skip)
    ts = [t for t in (g, x, y, g_skip) if t is not None]
    _build.require_cuda(*ts, dtype=BF16)
    gx = torch.empty_like(x)
    if gx.numel() == 0:
        return gx
    _build.launch("mimo_pool2x2_bwd", x.device, g.data_ptr(), x.data_ptr(),
                  y.data_ptr(), None if g_skip is None else g_skip.data_ptr(),
                  gx.data_ptr(), n, h, w, c)
    max_pool2x2_bwd.launches += 1
    return gx


class MaxPool2x2(torch.autograd.Function):
    """y = max_pool2x2(x), backward ``max_pool2x2_bwd``."""

    @staticmethod
    def forward(ctx, x):
        y = max_pool2x2(x)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return max_pool2x2_bwd(g.contiguous(), x, y)


class MaxPool2x2Skip(torch.autograd.Function):
    """(max_pool2x2(x), x): the identity's cotangent joins the pool's in
    one backward pass (``max_pool2x2_skip_ct``)."""

    @staticmethod
    def forward(ctx, x):
        y = max_pool2x2(x)
        ctx.save_for_backward(x, y)
        return y, x.view_as(x)

    @staticmethod
    def backward(ctx, g, g_skip):
        x, y = ctx.saved_tensors
        g = torch.zeros_like(y) if g is None else g.contiguous()
        return max_pool2x2_bwd(g, x, y,
                               None if g_skip is None else g_skip.contiguous())


max_pool2x2.launches = 0
max_pool2x2_bwd.launches = 0
