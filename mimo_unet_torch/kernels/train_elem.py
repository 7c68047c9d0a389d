"""Elementwise train-path kernels with per-group channel parameters.

Kernel source: ``csrc/train_elem.cu``.  Activations are channels-last bf16
``[N, H, W, C]`` with the subnetwork groups folded S-major into N (image n
uses group n // (N / G)); per-group parameters are f32 ``[G, C]``.

  * ``g_eff`` (K9): ``dy + dsum_g + 2*y*dsumsq_g`` rounded to bf16, the
    BatchNorm statistics' cotangents folded into the conv output's.
    Replaces ``mimo_unet_tpu/ops/pallas/ct_elem.py:140`` ``g_eff_ct``.
  * ``affine_relu`` / ``affine_relu_bwd`` (K8): ``relu(y*scale + shift)``
    and its backward (dy, dscale, dshift); ``AffineRelu`` is the
    ``autograd.Function``.  Replaces ``ct_elem.py:83`` ``affine_relu_ct``
    and its VJP ``_affine_relu_bwd`` (:106).
  * ``conv1x1_prelu`` / ``conv1x1_prelu_bwd`` (K12):
    ``wo_g^T . bf16(relu(y*scale + shift)) + bo_g`` rounded to bf16, and
    its backward (dy, dscale, dshift, dwo, dbo); ``Conv1x1Prelu`` is the
    ``autograd.Function``.  Replaces ``ct_elem.py:527`` ``conv1x1_prelu_ct``
    and ``_conv1x1_prelu_bwd`` (:560).
  * ``conv1x1`` / ``conv1x1_bwd`` (K11): the grouped 1x1 out-conv
    ``wo_g^T . z + bo_g`` rounded to bf16, and its backward (dz, dwo, dbo);
    ``Conv1x1`` is the ``autograd.Function``.  The dropout routes run it:
    a live dropout site between the decoder's DoubleConv and its out-conv
    keeps the 1x1 out of the fused kernels.  Replaces ``ct_elem.py:437``
    ``conv1x1_ct`` and ``_conv1x1_bwd`` (:464); both ways are K12's
    kernels without the prologue.

Parameters may be per image (G = N): the Dropout2d sites of the train
path fold into the affine (``models/fast_path.py`` ``_per_image_affine``).

Rounding points (both versions, ct_elem.py:83-160, :527-600): the affine in
f32 from the bf16 input as a multiply then an add; z rounded to bf16 before
the 1x1 product; dy rounded once; the reductions in f32.  The kernels sum
per block and reduce the blocks per group in a second, fixed-order pass
(``reduce_groups``); the plain versions sum with torch.  The backward of
K8, K11 and K12, one kernel, runs a few persistent blocks a group, one
partial row each (``prelu_bwd_blocks``, ``affine_relu_bwd_blocks``,
``conv1x1_bwd_blocks``).  K11's dz is the FMA chain
``fma(wo[c, j], g[j], .)`` over j in order from +0, rounded once.  K8's
backward takes C <= 256, as K5, which writes its input, does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mimo_unet_torch.kernels import _build

BF16 = torch.bfloat16
# K8's, K11's and K12's backward (csrc/train_elem.cu affine_bwd_kernel): bytes of
# y and cotangent a staged tile holds, blocks of a launch at most, tiles a
# block takes at least, and K8's channels at most (threads a block)
K12_TILE_BYTES, K12_BLOCKS, K12_MIN_TILES = 16384, 4 * 132, 4
K8_CMAX = 256


# ---------------------------------------------------------------- helpers

def per_image(t: torch.Tensor, n: int) -> torch.Tensor:
    """[G, C] per-group parameters -> [N, 1, 1, C] f32, image n of group
    n // (N / G)."""
    g = t.shape[0]
    return t.float().repeat_interleave(n // g, dim=0)[:, None, None, :]


def group_sum(t: torch.Tensor, groups: int) -> torch.Tensor:
    """[N, H, W, C] -> [G, C]: the sum over each group's images and
    pixels."""
    return t.reshape(groups, -1, t.shape[-1]).sum(dim=1)


def reduce_groups(partial: torch.Tensor, groups: int) -> torch.Tensor:
    """[G * P, L] per-block partials (each group's P blocks contiguous) ->
    [G, L], summed in a fixed order on the card."""
    rows, l = partial.shape
    out = torch.empty((groups, l), device=partial.device, dtype=torch.float32)
    _build.launch("mimo_reduce_groups", partial.device, partial.data_ptr(),
                  out.data_ptr(), groups, rows // groups, l)
    return out


def _check_act(y: torch.Tensor, params, c: Optional[int] = None) -> int:
    """[N, H, W, C] activation with [G, C] parameters; returns G."""
    if y.ndim != 4:
        raise ValueError(f"expected [N, H, W, C], got {tuple(y.shape)}")
    c = y.shape[-1] if c is None else c
    g = params[0].shape[0]
    for t in params:
        if tuple(t.shape) != (g, c):
            raise ValueError(f"parameters must be [G, {c}], got {tuple(t.shape)}")
    if y.shape[0] % g:
        raise ValueError(f"N={y.shape[0]} must divide into {g} groups")
    return g


def _conv1x1_ok(y: torch.Tensor) -> None:
    """What the 1x1 kernels take: at most 128 input channels
    (csrc/train_elem.cu CMAX)."""
    if y.shape[-1] > 128:
        raise ValueError(f"the 1x1 kernels take C <= 128, got {tuple(y.shape)}")


def prelu_bwd_blocks(n: int, hw: int, c: int, oc: int, groups: int) -> int:
    """Blocks of ``conv1x1_prelu_bwd``'s kernel, one partial row each:
    K12_BLOCKS over the groups (at least one a group), each taking at
    least K12_MIN_TILES tiles of K12_TILE_BYTES of y and cotangent (oc
    channels a pixel)."""
    tile = max(8, (K12_TILE_BYTES // (2 * (c + oc))) & ~7)
    tiles = -(-(n // groups * hw) // tile)
    return groups * min(max(1, K12_BLOCKS // groups), -(-tiles // K12_MIN_TILES))


def affine_relu_bwd_blocks(n: int, hw: int, c: int, groups: int) -> int:
    """Blocks of ``affine_relu_bwd``'s kernel, one partial row each: K12's
    backward kernel with dz (c channels) for its cotangent."""
    return prelu_bwd_blocks(n, hw, c, c, groups)


def conv1x1_bwd_blocks(n: int, hw: int, c: int, oc: int, groups: int) -> int:
    """Blocks of ``conv1x1_bwd``'s kernel, one partial row each: K12's
    backward kernel without the prologue, the same tiles."""
    return prelu_bwd_blocks(n, hw, c, oc, groups)


def _f32(*ts):
    return [t.float().contiguous() for t in ts]


# ---------------------------------------------------------------- K9 g_eff

def g_eff_plain(dy, y, dsum, dsumsq):
    """Plain PyTorch version of ``g_eff``."""
    n = y.shape[0]
    g = (dy.float() + per_image(dsum, n)) + (2.0 * y.float()) * per_image(dsumsq, n)
    return g.to(BF16)


def g_eff(dy: torch.Tensor, y: torch.Tensor, dsum: torch.Tensor,
          dsumsq: torch.Tensor) -> torch.Tensor:
    """dy, y [N, H, W, O] bf16; dsum, dsumsq [G, O] f32 -> [N, H, W, O]
    bf16.  CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    groups = _check_act(y, (dsum, dsumsq))
    if dy.shape != y.shape:
        raise ValueError("dy and y differ in shape")
    if y.device.type == "cpu":
        return g_eff_plain(dy, y, dsum, dsumsq)
    ds, dq = _f32(dsum, dsumsq)
    _build.require_cuda(dy, y, ds, dq)
    _build.require_cuda(dy, y, dtype=BF16)
    n, h, w, o = y.shape
    out = torch.empty_like(y)
    _build.launch("mimo_g_eff", y.device, dy.data_ptr(), y.data_ptr(),
                  ds.data_ptr(), dq.data_ptr(), out.data_ptr(), n, h * w, o,
                  groups)
    g_eff.launches += 1
    return out


# ---------------------------------------------------------------- K8 affine + relu

def affine_relu_plain(y, scale, shift):
    """Plain PyTorch version of ``affine_relu``."""
    n = y.shape[0]
    return torch.relu(y.float() * per_image(scale, n)
                      + per_image(shift, n)).to(BF16)


def affine_relu(y: torch.Tensor, scale: torch.Tensor,
                shift: torch.Tensor) -> torch.Tensor:
    """relu(y*scale_g + shift_g): y [N, H, W, C] bf16, scale/shift [G, C]
    f32 -> [N, H, W, C] bf16."""
    groups = _check_act(y, (scale, shift))
    if y.device.type == "cpu":
        return affine_relu_plain(y, scale, shift)
    sc, sh = _f32(scale, shift)
    _build.require_cuda(y, sc, sh)
    _build.require_cuda(y, dtype=BF16)
    n, h, w, c = y.shape
    z = torch.empty_like(y)
    _build.launch("mimo_affine_relu", y.device, y.data_ptr(), sc.data_ptr(),
                  sh.data_ptr(), z.data_ptr(), n, h * w, c, groups)
    affine_relu.launches += 1
    return z


def affine_relu_bwd_plain(dz, y, scale, shift):
    """Plain PyTorch version of ``affine_relu_bwd``."""
    n, groups = y.shape[0], scale.shape[0]
    yv = y.float()
    sc = per_image(scale, n)
    a = yv * sc + per_image(shift, n)
    da = torch.where(a > 0, dz.float(), torch.zeros((), dtype=torch.float32,
                                                    device=y.device))
    return ((da * sc).to(BF16), group_sum(da * yv, groups),
            group_sum(da, groups))


def affine_relu_bwd(dz: torch.Tensor, y: torch.Tensor, scale: torch.Tensor,
                    shift: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of ``affine_relu``: (dy bf16, dscale [G, C], dshift [G, C])."""
    groups = _check_act(y, (scale, shift))
    if dz.shape != y.shape:
        raise ValueError("dz and y differ in shape")
    if y.device.type == "cpu":
        return affine_relu_bwd_plain(dz, y, scale, shift)
    if y.shape[-1] > K8_CMAX:
        raise ValueError(f"affine_relu_bwd takes C <= {K8_CMAX}, got {tuple(y.shape)}")
    sc, sh = _f32(scale, shift)
    _build.require_cuda(dz, y, sc, sh)
    _build.require_cuda(dz, y, dtype=BF16)
    n, h, w, c = y.shape
    dy = torch.empty_like(y)
    rows = affine_relu_bwd_blocks(n, h * w, c, groups)
    # dscale's partial rows, then dshift's: one reduce_groups pass over
    # 2 * groups groups of rows
    part = torch.empty((2, rows, c), device=y.device, dtype=torch.float32)
    _build.launch("mimo_affine_relu_bwd", y.device, dz.data_ptr(), y.data_ptr(),
                  sc.data_ptr(), sh.data_ptr(), dy.data_ptr(), part[0].data_ptr(),
                  part[1].data_ptr(), n, h * w, c, groups)
    affine_relu_bwd.launches += 1
    red = reduce_groups(part.view(2 * rows, c), 2 * groups)
    return dy, red[:groups], red[groups:]


class AffineRelu(torch.autograd.Function):
    """Differentiable ``affine_relu`` (the JAX package's custom VJP)."""

    @staticmethod
    def forward(ctx, y, scale, shift):
        ctx.save_for_backward(y, scale, shift)
        return affine_relu(y, scale, shift)

    @staticmethod
    def backward(ctx, dz):
        y, scale, shift = ctx.saved_tensors
        dy, dsc, dsh = affine_relu_bwd(dz.contiguous(), y, scale, shift)
        return dy, dsc.to(scale.dtype), dsh.to(shift.dtype)


# ---------------------------------------------------------------- K12 conv1x1 + prologue

def _check_wo(y, wo, bo, groups: int) -> None:
    c = y.shape[-1]
    if wo.ndim != 3 or wo.shape[:2] != (groups, c) or wo.shape[2] > 8:
        raise ValueError(f"wo must be [{groups}, {c}, OC<=8], got {tuple(wo.shape)}")
    if tuple(bo.shape) != (groups, wo.shape[2]):
        raise ValueError(f"bo must be [{groups}, {wo.shape[2]}], got {tuple(bo.shape)}")


def _check_1x1(y, scale, shift, wo, bo) -> int:
    groups = _check_act(y, (scale, shift))
    _check_wo(y, wo, bo, groups)
    return groups


def conv1x1_prelu_plain(y, scale, shift, wo, bo):
    """Plain PyTorch version of ``conv1x1_prelu``."""
    return conv1x1_plain(affine_relu_plain(y, scale, shift), wo, bo)


def conv1x1_prelu(y: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                  wo: torch.Tensor, bo: torch.Tensor) -> torch.Tensor:
    """The decoder's last BatchNorm affine, ReLU and 1x1 out-conv per group:
    y [N, H, W, C] bf16, scale/shift [G, C], wo [G, C, OC] (used in bf16),
    bo [G, OC] f32 -> logits [N, H, W, OC] bf16."""
    groups = _check_1x1(y, scale, shift, wo, bo)
    if y.device.type == "cpu":
        return conv1x1_prelu_plain(y, scale, shift, wo, bo)
    _conv1x1_ok(y)
    sc, sh, bof = _f32(scale, shift, bo)
    wob = wo.to(BF16).contiguous()
    _build.require_cuda(y, sc, sh, bof, wob)
    _build.require_cuda(y, dtype=BF16)
    n, h, w, c = y.shape
    oc = wo.shape[2]
    out = torch.empty((n, h, w, oc), device=y.device, dtype=BF16)
    _build.launch("mimo_conv1x1_prelu", y.device, y.data_ptr(), sc.data_ptr(),
                  sh.data_ptr(), wob.data_ptr(), bof.data_ptr(), out.data_ptr(),
                  n, h * w, c, oc, groups)
    conv1x1_prelu.launches += 1
    return out


def conv1x1_prelu_bwd_plain(g, y, scale, shift, wo):
    """Plain PyTorch version of ``conv1x1_prelu_bwd``."""
    n, groups = y.shape[0], scale.shape[0]
    yv = y.float()
    sc = per_image(scale, n)
    a = yv * sc + per_image(shift, n)
    dz, dwo, dbo = _conv1x1_bwd_f32(g, torch.relu(a).to(BF16), wo)
    da = torch.where(a > 0, dz, torch.zeros((), dtype=torch.float32,
                                            device=y.device))
    return ((da * sc).to(BF16), group_sum(da * yv, groups),
            group_sum(da, groups), dwo, dbo)


def conv1x1_prelu_bwd(g: torch.Tensor, y: torch.Tensor, scale: torch.Tensor,
                      shift: torch.Tensor, wo: torch.Tensor):
    """Backward of ``conv1x1_prelu`` for the logits' cotangent g
    [N, H, W, OC] bf16: (dy bf16, dscale [G, C], dshift [G, C],
    dwo [G, C, OC], dbo [G, OC]), all but dy f32."""
    groups = _check_1x1(y, scale, shift, wo, wo[:, 0, :])
    if g.shape[:3] != y.shape[:3] or g.shape[3] != wo.shape[2]:
        raise ValueError(f"g must be [N, H, W, {wo.shape[2]}], got {tuple(g.shape)}")
    if y.device.type == "cpu":
        return conv1x1_prelu_bwd_plain(g, y, scale, shift, wo)
    _conv1x1_ok(y)
    sc, sh = _f32(scale, shift)
    wob = wo.to(BF16).contiguous()
    _build.require_cuda(g, y, sc, sh, wob)
    _build.require_cuda(g, y, dtype=BF16)
    n, h, w, c = y.shape
    oc = wo.shape[2]
    dy = torch.empty_like(y)
    partial = torch.empty((prelu_bwd_blocks(n, h * w, c, oc, groups),
                           c * oc + oc + 2 * c), device=y.device, dtype=torch.float32)
    _build.launch("mimo_conv1x1_prelu_bwd", y.device, g.data_ptr(),
                  y.data_ptr(), sc.data_ptr(), sh.data_ptr(), wob.data_ptr(),
                  dy.data_ptr(), partial.data_ptr(), n, h * w, c, oc, groups)
    conv1x1_prelu_bwd.launches += 1
    red = reduce_groups(partial, groups)
    dwo = red[:, :c * oc].reshape(groups, c, oc)
    dbo = red[:, c * oc:c * oc + oc]
    dsc = red[:, c * oc + oc:c * oc + oc + c]
    dsh = red[:, c * oc + oc + c:]
    return dy, dsc, dsh, dwo, dbo


class Conv1x1Prelu(torch.autograd.Function):
    """Differentiable ``conv1x1_prelu`` (the JAX package's custom VJP)."""

    @staticmethod
    def forward(ctx, y, scale, shift, wo, bo):
        ctx.save_for_backward(y, scale, shift, wo)
        return conv1x1_prelu(y, scale, shift, wo, bo)

    @staticmethod
    def backward(ctx, g):
        y, scale, shift, wo = ctx.saved_tensors
        dy, dsc, dsh, dwo, dbo = conv1x1_prelu_bwd(g.contiguous(), y, scale,
                                                   shift, wo)
        return (dy, dsc.to(scale.dtype), dsh.to(shift.dtype),
                dwo.to(wo.dtype), dbo)


# ---------------------------------------------------------------- K11 grouped conv1x1

def _check_z(z, wo, bo) -> int:
    """z [N, H, W, C] with wo [G, C, OC<=8] and bo [G, OC]; returns G."""
    if z.ndim != 4:
        raise ValueError(f"expected [N, H, W, C], got {tuple(z.shape)}")
    groups = wo.shape[0]
    _check_wo(z, wo, bo, groups)
    if z.shape[0] % groups:
        raise ValueError(f"N={z.shape[0]} must divide into {groups} groups")
    return groups


def conv1x1_plain(z, wo, bo):
    """Plain PyTorch version of ``conv1x1``."""
    n, h, w, c = z.shape
    groups = wo.shape[0]
    zf = z.float().reshape(groups, -1, c)
    out = torch.bmm(zf, wo.to(BF16).float()) + bo.float()[:, None, :]
    return out.reshape(n, h, w, -1).to(BF16)


def conv1x1(z: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor) -> torch.Tensor:
    """The grouped 1x1 out-conv: z [N, H, W, C] bf16, wo [G, C, OC] (used
    in bf16), bo [G, OC] f32 -> [N, H, W, OC] bf16; image n uses group
    n // (N / G).  CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    groups = _check_z(z, wo, bo)
    if z.device.type == "cpu":
        return conv1x1_plain(z, wo, bo)
    _conv1x1_ok(z)
    bof = bo.float().contiguous()
    wob = wo.to(BF16).contiguous()
    _build.require_cuda(z, wob, bof)
    _build.require_cuda(z, dtype=BF16)
    n, h, w, c = z.shape
    oc = wo.shape[2]
    out = torch.empty((n, h, w, oc), device=z.device, dtype=BF16)
    _build.launch("mimo_conv1x1", z.device, z.data_ptr(), wob.data_ptr(),
                  bof.data_ptr(), out.data_ptr(), n, h * w, c, oc, groups)
    conv1x1.launches += 1
    return out


def _conv1x1_bwd_f32(g, z, wo):
    """(dz f32 [N, H, W, C], dwo [G, C, OC], dbo [G, OC]) of the grouped
    1x1 for the cotangent g, from bf16 operands in f32."""
    n, h, w, c = z.shape
    groups = wo.shape[0]
    zf = z.float().reshape(groups, -1, c)
    gf = g.float().reshape(groups, -1, g.shape[-1])
    dz = torch.bmm(gf, wo.to(BF16).float().transpose(1, 2))
    return (dz.reshape(n, h, w, c), torch.bmm(zf.transpose(1, 2), gf),
            gf.sum(dim=1))


def conv1x1_bwd_plain(g, z, wo):
    """Plain PyTorch version of ``conv1x1_bwd``."""
    dz, dwo, dbo = _conv1x1_bwd_f32(g, z, wo)
    return dz.to(BF16), dwo, dbo


def conv1x1_bwd(g: torch.Tensor, z: torch.Tensor, wo: torch.Tensor):
    """Backward of ``conv1x1`` for the output's cotangent g [N, H, W, OC]
    bf16: (dz bf16, dwo [G, C, OC] f32, dbo [G, OC] f32)."""
    groups = _check_z(z, wo, wo[:, 0, :])
    if g.shape[:3] != z.shape[:3] or g.shape[3] != wo.shape[2]:
        raise ValueError(f"g must be [N, H, W, {wo.shape[2]}], got {tuple(g.shape)}")
    if z.device.type == "cpu":
        return conv1x1_bwd_plain(g, z, wo)
    _conv1x1_ok(z)
    wob = wo.to(BF16).contiguous()
    _build.require_cuda(g, z, wob)
    _build.require_cuda(g, z, dtype=BF16)
    n, h, w, c = z.shape
    oc = wo.shape[2]
    dz = torch.empty_like(z)
    partial = torch.empty((conv1x1_bwd_blocks(n, h * w, c, oc, groups), c * oc + oc),
                          device=z.device, dtype=torch.float32)
    _build.launch("mimo_conv1x1_bwd", z.device, g.data_ptr(), z.data_ptr(),
                  wob.data_ptr(), dz.data_ptr(), partial.data_ptr(), n, h * w,
                  c, oc, groups)
    conv1x1_bwd.launches += 1
    red = reduce_groups(partial, groups)
    return dz, red[:, :c * oc].reshape(groups, c, oc), red[:, c * oc:]


class Conv1x1(torch.autograd.Function):
    """Differentiable ``conv1x1`` (the JAX package's custom VJP)."""

    @staticmethod
    def forward(ctx, z, wo, bo):
        ctx.save_for_backward(z, wo)
        return conv1x1(z, wo, bo)

    @staticmethod
    def backward(ctx, g):
        z, wo = ctx.saved_tensors
        dz, dwo, dbo = conv1x1_bwd(g.contiguous(), z, wo)
        return dz, dwo.to(wo.dtype), dbo


g_eff.launches = 0
affine_relu.launches = 0
affine_relu_bwd.launches = 0
conv1x1_prelu.launches = 0
conv1x1_prelu_bwd.launches = 0
conv1x1.launches = 0
conv1x1_bwd.launches = 0
