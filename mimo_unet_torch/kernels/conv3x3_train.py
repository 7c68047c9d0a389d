"""Train-mode 3x3 reflect conv per subnetwork group and its backward.

Kernel source: ``csrc/conv3x3_train.cu``.  Counterpart of
``mimo_unet_tpu/ops/pallas/ct_train.py`` ``conv3x3_ct_train`` (:1099) with
its custom VJP (``_train_fwd_rule`` / ``_train_bwd_rule``, :1128-1273):

  * ``conv3x3_fwd`` (K5): y = conv(z) with no bias, z = x or the prologue
    relu(x*scale + shift), plus the per-group sum and sum of squares of
    the bf16 y (the BatchNorm batch statistics).  Replaces ``_conv_fwd``
    (:283).
  * ``conv3x3_dx`` (K6, plain form): the transposed conv with the reflect
    folds, the prologue backward fused in (dscale, dshift).  Replaces
    ``_conv_dx`` (:579).
  * ``conv3x3_dx_fold`` (K6, fold form): the same for a conv with a second
    input x2 shared by the S groups (image n reads x2 image n % N2); the x2
    cotangent is summed over its S repetitions.  Replaces
    ``_conv_dx_fold_call`` (:677).
  * ``conv3x3_dw`` (K7): the per-group weight gradient, the recomputed z
    contracted with the cotangent over N*H*W.  Replaces ``_conv_dw`` (:815).
  * ``Conv3x3Train``: the ``autograd.Function``; its backward folds the
    statistics' cotangents in with ``g_eff`` (K9) first.

Layouts on the card (the CT layout, align8 padding and tile ladders are TPU
constraints and are not ported): activations channels-last bf16
``[N, H, W, C]`` with the groups folded S-major into N (image n uses group
n // (N / G)); weights HWIO per group ``[G, 3, 3, C_in, O]``; prologue
scale/shift f32 ``[G, C_in]``.  The kernels take H*W a multiple of 128.

Rounding points (both versions): bf16 operands, f32 accumulation; z
computed in f32 and rounded to bf16 (ct_train.py:151-156); y rounded to
bf16 and its statistics taken of the rounded values (:220-224); dx rounded
once; the fold's per-image x2 cotangents rounded, summed in f32, rounded
(:533-556); dw in f32.  The plain versions compute the transposes by
autograd through an f32 reflect conv.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from mimo_unet_torch.kernels import _build
from mimo_unet_torch.kernels.train_elem import (
    g_eff,
    group_sum,
    per_image,
    reduce_groups,
)

BF16 = torch.bfloat16
BM, BN = 128, 32      # the kernels' GEMM tile (pixels x channels)
DW_CHUNK = 16384      # pixels per dw block: partials per group = pixels / chunk


def _pad_to(t: torch.Tensor, k: int) -> torch.Tensor:
    return F.pad(t, (0, k - t.shape[-1])).contiguous()


def _cols(c: int) -> int:
    return -(-c // BN) * BN


def _check(x1, w, x2, scale, shift) -> Tuple[int, int, int]:
    """Shape rules shared by the kernels and their plain versions; returns
    (groups, c_in, o)."""
    if x1.ndim != 4:
        raise ValueError(f"x1 must be [N, H, W, C], got {tuple(x1.shape)}")
    n, h, w_, c1 = x1.shape
    c2 = 0 if x2 is None else x2.shape[-1]
    if w.ndim != 5 or w.shape[1:3] != (3, 3) or w.shape[3] != c1 + c2:
        raise ValueError(f"w must be [G, 3, 3, {c1 + c2}, O], got {tuple(w.shape)}")
    g, o = w.shape[0], w.shape[4]
    if n % g or h < 3 or w_ < 3:
        raise ValueError(f"N={n} must divide into {g} groups; H, W >= 3")
    if x2 is not None and (x2.ndim != 4 or x2.shape[1:3] != (h, w_)
                           or n % x2.shape[0]):
        raise ValueError(f"x2 must be [N2, {h}, {w_}, C2] with N % N2 == 0, "
                         f"got {tuple(x2.shape)}")
    if (scale is None) != (shift is None):
        raise ValueError("scale and shift come together")
    if scale is not None:
        if x2 is not None:
            raise ValueError("the prologue applies to a single input")
        for t in (scale, shift):
            if tuple(t.shape) != (g, c1):
                raise ValueError(f"prologue must be [{g}, {c1}], got {tuple(t.shape)}")
    return g, c1 + c2, o


def _kernel_ok(x1: torch.Tensor) -> None:
    n, h, w, _ = x1.shape
    if (h * w) % BM:
        raise ValueError(f"the conv kernels need H*W % {BM} == 0, got {h}x{w}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------- plain versions

def _z_plain(x1, x2, scale, shift) -> torch.Tensor:
    """The conv input as f32 NCHW: prologue z rounded to bf16, x2 tiled."""
    n = x1.shape[0]
    z = x1.float()
    if scale is not None:
        z = torch.relu(z * per_image(scale, n) + per_image(shift, n)).to(BF16).float()
    if x2 is not None:
        z = torch.cat([z, x2.float().repeat(n // x2.shape[0], 1, 1, 1)], dim=-1)
    return z.permute(0, 3, 1, 2)


def _conv_f32(z: torch.Tensor, w_hwio: torch.Tensor) -> torch.Tensor:
    """f32 reflect 3x3 conv of NCHW z with the bf16-rounded HWIO weights."""
    w = w_hwio.to(BF16).float().permute(3, 2, 0, 1)
    return F.conv2d(F.pad(z, (1, 1, 1, 1), mode="reflect"), w)


def _dz_plain(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Transpose of the reflect conv applied to g: [N, H, W, O] ->
    [N, H, W, C_in] f32, by autograd through ``_conv_f32``."""
    n, h, wd, o = g.shape
    groups, cin = w.shape[0], w.shape[3]
    per = n // groups
    outs = []
    for gi in range(groups):
        z = torch.zeros((per, cin, h, wd), device=g.device, requires_grad=True)
        with torch.enable_grad():
            y = _conv_f32(z, w[gi].detach())
            (dz,) = torch.autograd.grad(
                y, z, g[gi * per:(gi + 1) * per].float().permute(0, 3, 1, 2))
        outs.append(dz)
    return torch.cat(outs).permute(0, 2, 3, 1)


def conv3x3_fwd_plain(x1, w, *, x2=None, scale=None, shift=None):
    """Plain PyTorch version of ``conv3x3_fwd``."""
    groups, _, _ = _check(x1, w, x2, scale, shift)
    z = _z_plain(x1, x2, scale, shift)
    per = x1.shape[0] // groups
    y = torch.cat([_conv_f32(z[gi * per:(gi + 1) * per], w[gi])
                   for gi in range(groups)]).permute(0, 2, 3, 1).to(BF16)
    yf = y.float()
    return y.contiguous(), group_sum(yf, groups), group_sum(yf * yf, groups)


def conv3x3_dx_plain(g, w, *, x1=None, scale=None, shift=None):
    """Plain PyTorch version of ``conv3x3_dx``."""
    dz = _dz_plain(g, w)
    if scale is None:
        return dz.to(BF16).contiguous()
    n, groups = g.shape[0], w.shape[0]
    xv = x1.float()
    sc = per_image(scale, n)
    a = xv * sc + per_image(shift, n)
    da = torch.where(a > 0, dz, torch.zeros((), dtype=torch.float32,
                                            device=g.device))
    return ((da * sc).to(BF16).contiguous(), group_sum(da * xv, groups),
            group_sum(da, groups))


def conv3x3_dx_fold_plain(g, w, c1: int, n2: int):
    """Plain PyTorch version of ``conv3x3_dx_fold``."""
    dz = _dz_plain(g, w)
    dx1 = dz[..., :c1].to(BF16).contiguous()
    dz2 = dz[..., c1:].to(BF16).float()
    dx2 = dz2.reshape(-1, n2, *dz2.shape[1:]).sum(dim=0)
    return dx1, dx2.to(BF16).contiguous()


def conv3x3_dw_plain(g, x1, groups: int, *, x2=None, scale=None, shift=None):
    """Plain PyTorch version of ``conv3x3_dw``: [G, 3, 3, C_in, O] f32."""
    n = g.shape[0]
    z = _z_plain(x1, x2, scale, shift)
    cin = z.shape[1]
    per = n // groups
    outs = []
    for gi in range(groups):
        w0 = torch.zeros((3, 3, cin, g.shape[-1]), device=g.device,
                         requires_grad=True)
        with torch.enable_grad():
            y = F.conv2d(F.pad(z[gi * per:(gi + 1) * per], (1, 1, 1, 1),
                               mode="reflect"), w0.permute(3, 2, 0, 1))
            (dw,) = torch.autograd.grad(
                y, w0, g[gi * per:(gi + 1) * per].float().permute(0, 3, 1, 2))
        outs.append(dw)
    return torch.stack(outs)


# ---------------------------------------------------------------- kernels

def _prologue_args(scale, shift):
    if scale is None:
        return None, None
    return scale.float().contiguous(), shift.float().contiguous()


def conv3x3_fwd(x1: torch.Tensor, w: torch.Tensor, *,
                x2: Optional[torch.Tensor] = None,
                scale: Optional[torch.Tensor] = None,
                shift: Optional[torch.Tensor] = None):
    """K5.  x1 [N, H, W, C1] bf16; x2 optional [N2, H, W, C2] bf16 (image n
    reads x2 image n % N2); w [G, 3, 3, C1+C2, O] (used in bf16);
    scale/shift optional [G, C1] f32 prologue.  Returns (y [N, H, W, O]
    bf16, sum [G, O] f32, sumsq [G, O] f32).  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    groups, cin, o = _check(x1, w, x2, scale, shift)
    if x1.device.type == "cpu":
        return conv3x3_fwd_plain(x1, w, x2=x2, scale=scale, shift=shift)
    _kernel_ok(x1)
    n, h, wd, c1 = x1.shape
    wk = _pad_to(w.reshape(groups, 9 * cin, o).to(BF16), _cols(o))
    sc, sh = _prologue_args(scale, shift)
    _build.require_cuda(*[t for t in (x1, x2, wk, sc, sh) if t is not None])
    _build.require_cuda(*[t for t in (x1, x2) if t is not None], dtype=BF16)
    y = torch.empty((n, h, wd, o), device=x1.device, dtype=BF16)
    tiles = n * h * wd // BM
    psum = torch.empty((tiles, o), device=x1.device, dtype=torch.float32)
    psq = torch.empty_like(psum)
    _build.launch("mimo_conv3x3_fwd", x1.device, _ptr(x1), _ptr(x2), _ptr(wk),
                  _ptr(sc), _ptr(sh), _ptr(y), _ptr(psum), _ptr(psq), n, h,
                  wd, c1, cin - c1, 0 if x2 is None else x2.shape[0], o,
                  groups, int(sc is not None))
    conv3x3_fwd.launches += 1
    return y, reduce_groups(psum, groups), reduce_groups(psq, groups)


def _wt(w: torch.Tensor) -> torch.Tensor:
    """[G, 3, 3, C, O] -> the dx GEMM's [G, 9*O, C padded] bf16."""
    groups, _, _, c, o = w.shape
    wt = w.to(BF16).reshape(groups, 9, c, o).transpose(2, 3)
    return _pad_to(wt.reshape(groups, 9 * o, c), _cols(c))


def conv3x3_dx(g: torch.Tensor, w: torch.Tensor, *,
               x1: Optional[torch.Tensor] = None,
               scale: Optional[torch.Tensor] = None,
               shift: Optional[torch.Tensor] = None):
    """K6, plain form.  g [N, H, W, O] bf16 cotangent of y; w
    [G, 3, 3, C, O].  Without a prologue returns dx [N, H, W, C] bf16; with
    one (x1 the conv's raw input, scale/shift [G, C]) returns (dx, dscale
    [G, C], dshift [G, C])."""
    groups, cin, o = _check(g.new_empty(g.shape[:3] + (w.shape[3],)), w, None,
                            scale, shift)
    if g.shape[-1] != o:
        raise ValueError(f"g must have {o} channels, got {g.shape[-1]}")
    if scale is not None and (x1 is None or x1.shape != g.shape[:3] + (cin,)):
        raise ValueError("the prologue backward needs x1 [N, H, W, C]")
    if g.device.type == "cpu":
        return conv3x3_dx_plain(g, w, x1=x1, scale=scale, shift=shift)
    _kernel_ok(g)
    n, h, wd, _ = g.shape
    wt = _wt(w)
    sc, sh = _prologue_args(scale, shift)
    xk = x1 if scale is not None else None
    _build.require_cuda(*[t for t in (g, wt, xk, sc, sh) if t is not None])
    _build.require_cuda(*[t for t in (g, xk) if t is not None], dtype=BF16)
    dx = torch.empty((n, h, wd, cin), device=g.device, dtype=BF16)
    pdsc = pdsh = None
    if sc is not None:
        pdsc = torch.empty((n * h * wd // BM, cin), device=g.device,
                           dtype=torch.float32)
        pdsh = torch.empty_like(pdsc)
    _build.launch("mimo_conv3x3_dx", g.device, _ptr(g), _ptr(wt), _ptr(xk),
                  _ptr(sc), _ptr(sh), _ptr(dx), None, _ptr(pdsc), _ptr(pdsh),
                  n, h, wd, o, cin, 0, 0, groups, int(sc is not None))
    conv3x3_dx.launches += 1
    if sc is None:
        return dx
    return dx, reduce_groups(pdsc, groups), reduce_groups(pdsh, groups)


def conv3x3_dx_fold(g: torch.Tensor, w: torch.Tensor, c1: int, n2: int):
    """K6, fold form, for a conv over the concat [x1, x2] where image n
    reads x2 image n % N2 and N = G * N2 (each x2 image shared once by each
    group).  g [N, H, W, O] bf16, w [G, 3, 3, C1+C2, O] -> (dx1 [N, H, W,
    C1], dx2 [N2, H, W, C2]) bf16, dx2 summed over the G images that read
    it."""
    n, h, wd, o = g.shape
    groups, cin = w.shape[0], w.shape[3]
    if w.ndim != 5 or w.shape[4] != o or not 0 < c1 < cin or n != groups * n2:
        raise ValueError(f"fold dx needs w [G, 3, 3, C1+C2, {o}], 0 < C1 < "
                         f"C1+C2 and N == G*N2; got w {tuple(w.shape)}, C1={c1}, "
                         f"N={n}, N2={n2}")
    if g.device.type == "cpu":
        return conv3x3_dx_fold_plain(g, w, c1, n2)
    _kernel_ok(g)
    wt = _wt(w)
    _build.require_cuda(g, wt)
    _build.require_cuda(g, dtype=BF16)
    dx1 = torch.empty((n, h, wd, c1), device=g.device, dtype=BF16)
    dx2 = torch.empty((n2, h, wd, cin - c1), device=g.device, dtype=BF16)
    _build.launch("mimo_conv3x3_dx", g.device, _ptr(g), _ptr(wt), None, None,
                  None, _ptr(dx1), _ptr(dx2), None, None, n, h, wd, o, c1,
                  cin - c1, n2, groups, 0)
    conv3x3_dx_fold.launches += 1
    return dx1, dx2


def conv3x3_dw(g: torch.Tensor, x1: torch.Tensor, groups: int, *,
               x2: Optional[torch.Tensor] = None,
               scale: Optional[torch.Tensor] = None,
               shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K7.  g [N, H, W, O] bf16 cotangent of y; x1, x2, scale, shift the
    forward's inputs -> dw [G, 3, 3, C1+C2, O] f32."""
    c1 = x1.shape[-1]
    cin = c1 + (0 if x2 is None else x2.shape[-1])
    o = g.shape[-1]
    _check(x1, g.new_empty((groups, 3, 3, cin, o)), x2, scale, shift)
    if g.shape[:3] != x1.shape[:3]:
        raise ValueError("g and x1 differ in N, H, W")
    if g.device.type == "cpu":
        return conv3x3_dw_plain(g, x1, groups, x2=x2, scale=scale, shift=shift)
    _kernel_ok(g)
    n, h, wd, _ = g.shape
    sc, sh = _prologue_args(scale, shift)
    _build.require_cuda(*[t for t in (g, x1, x2, sc, sh) if t is not None])
    _build.require_cuda(*[t for t in (g, x1, x2) if t is not None], dtype=BF16)
    chunks = -(-(n // groups * h * wd) // DW_CHUNK)
    partial = torch.empty((groups * chunks, 9 * cin * o), device=g.device,
                          dtype=torch.float32)
    _build.launch("mimo_conv3x3_dw", g.device, _ptr(x1), _ptr(x2), _ptr(g),
                  _ptr(sc), _ptr(sh), _ptr(partial), n, h, wd, c1, cin - c1,
                  0 if x2 is None else x2.shape[0], o, groups,
                  int(sc is not None), DW_CHUNK)
    conv3x3_dw.launches += 1
    return reduce_groups(partial, groups).view(groups, 3, 3, cin, o)


# ---------------------------------------------------------------- autograd

class Conv3x3Train(torch.autograd.Function):
    """(y, sum, sumsq) = conv3x3_fwd(x1, w, x2=x2, scale=scale, shift=shift)
    with the gradient of ``_train_bwd_rule`` (ct_train.py:1137): the
    statistics' cotangents fold into y's (g_eff, K9), then dx (K6, plain or
    fold form) and dw (K7).  dw is returned in w's dtype (the fast path
    passes bf16 weights, as the JAX package does)."""

    @staticmethod
    def forward(ctx, x1, x2, w, scale, shift):
        y, s, q = conv3x3_fwd(x1, w, x2=x2, scale=scale, shift=shift)
        ctx.save_for_backward(x1, x2, w, scale, shift, y)
        return y, s, q

    @staticmethod
    def backward(ctx, dy, dsum, dsumsq):
        x1, x2, w, scale, shift, y = ctx.saved_tensors
        groups = w.shape[0]
        if dy is None:
            dy = torch.zeros_like(y)
        zeros = torch.zeros((groups, y.shape[-1]), device=y.device)
        geff = g_eff(dy.contiguous(), y,
                     zeros if dsum is None else dsum,
                     zeros if dsumsq is None else dsumsq)
        need_x1, need_x2, need_w, need_sc, need_sh = ctx.needs_input_grad
        dx1 = dx2 = dw = dsc = dsh = None
        if x2 is not None:
            if need_x1 or need_x2:
                dx1, dx2 = conv3x3_dx_fold(geff, w, x1.shape[-1], x2.shape[0])
        elif scale is not None:
            if need_x1 or need_sc or need_sh:
                dx1, dsc, dsh = conv3x3_dx(geff, w, x1=x1, scale=scale,
                                           shift=shift)
                dsc, dsh = dsc.to(scale.dtype), dsh.to(shift.dtype)
        elif need_x1:
            dx1 = conv3x3_dx(geff, w)
        if need_w:
            dw = conv3x3_dw(geff, x1, groups, x2=x2, scale=scale,
                            shift=shift).to(w.dtype)
        return dx1, dx2, dw, dsc, dsh


conv3x3_fwd.launches = 0
conv3x3_dx.launches = 0
conv3x3_dx_fold.launches = 0
conv3x3_dw.launches = 0
