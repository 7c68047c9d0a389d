"""Fused eval DoubleConv: relu(bn2(conv2(relu(bn1(conv1(cat(x1, x2)))))))
with 3x3 reflect convs and BatchNorm + bias folded into (scale, shift).

Replaces ``mimo_unet_tpu/ops/pallas/ct_conv.py`` ``fused_double_conv_ct``
(:756, pallas_call at :942) with ``fused_double_conv`` and
``fused_double_conv9_ct`` (:496, pallas_call at :570; the c_in <= 8 in_conv
variant) with ``fused_double_conv9``.  Kernel: ``csrc/fused_double_conv.cu``.

Layout on the card (the CT layout, align8 padding and the tile ladders are
TPU constraints and are not ported):
  * activations channels-last bf16 ``[N, H, W, C]``, subnetworks folded
    S-major into N (n = s*B + b, mimo_unet_tpu/models/fast_path.py:392);
  * grouped weights ``[G, 3, 3, C_in, C_out]`` (HWIO per group; image n uses
    group n // (N/G)); f32 scale and shift ``[G, C]``.

Rounding points (both versions): bf16 operands, f32 accumulation, the
affine and relu on the f32 accumulator, the mid activation rounded to bf16
before conv2, the output rounded to bf16; the fused 1x1 out-conv takes the
bf16 output and bf16 weights, adds its f32 bias and rounds the logits to
bf16 (ct_conv.py:294-299).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from mimo_unet_torch.kernels import _build
from mimo_unet_torch.kernels.upsample2x import _h_tables

BF16 = torch.bfloat16


def _as_bf16_f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(BF16).float()


def lerp_h2x_plain(x: torch.Tensor) -> torch.Tensor:
    """H half of the bilinear x2 align-corners upsample: [N, H/2, W, C] ->
    [N, H, W, C] bf16, as the kernels do it (ct_conv.py:215-231,
    ct_train.py:255): full row r lerps half rows lo and lo + 1,
    ``bf16(a*(1-f) + b*f)`` with each operation rounded, from the x2
    upsample's row tables (``upsample2x._h_tables``).  There f is
    ``float32(r*(H/2-1) - lo*(H-1)) * float32(1/(H-1))``: the reference
    divides by H-1, and XLA compiles that division by a constant into the
    multiply by its f32 reciprocal (one f32 ulp from the quotient at some
    rows)."""
    h = 2 * x.shape[1]
    lo, fa, fb, _ = _h_tables(x.shape[1], x.device)
    lo = lo.long()
    a, b = x[:, lo].float(), x[:, lo + 1].float()
    return (a * fa.view(1, h, 1, 1) + b * fb.view(1, h, 1, 1)).to(BF16)


def _conv3x3_reflect_f32(x: torch.Tensor, w_hwio: torch.Tensor) -> torch.Tensor:
    """f32 3x3 reflect conv of NCHW ``x`` with bf16-rounded HWIO weights."""
    w = _as_bf16_f32(w_hwio).permute(3, 2, 0, 1)
    return F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), w)


def _group_rows(t: torch.Tensor, groups: int) -> torch.Tensor:
    """[G*P, H, W, C] -> [P, H, W, G*C]: group g in channel block g."""
    n, h, w, c = t.shape
    return (t.view(groups, n // groups, h, w, c).permute(1, 2, 3, 0, 4)
            .reshape(n // groups, h, w, groups * c))


def _check(x1, w1, s1, sh1, w2, s2, sh2, x2, x2_half_h, wo, bo, emit_hpool,
           group_rows_out):
    """Shape rules shared by the kernel and its plain version."""
    if x1.ndim != 4:
        raise ValueError(f"x1 must be [N, H, W, C], got {tuple(x1.shape)}")
    n, h, w, c1 = x1.shape
    g = w1.shape[0]
    c2 = 0 if x2 is None else x2.shape[-1]
    if w1.shape[1:3] != (3, 3) or w1.shape[3] != c1 + c2:
        raise ValueError(f"w1 must be [G, 3, 3, {c1 + c2}, M], got {tuple(w1.shape)}")
    m = w1.shape[4]
    if w2.shape[:4] != (g, 3, 3, m):
        raise ValueError(f"w2 must be [{g}, 3, 3, {m}, O], got {tuple(w2.shape)}")
    o = w2.shape[4]
    for t, c in ((s1, m), (sh1, m), (s2, o), (sh2, o)):
        if tuple(t.shape) != (g, c):
            raise ValueError(f"affine must be [{g}, {c}], got {tuple(t.shape)}")
    if n % g or h < 2 or w < 2:
        raise ValueError(f"N={n} must divide into {g} groups; H, W >= 2")
    if x2 is not None:
        h_x2 = h // 2 if x2_half_h else h
        if x2.ndim != 4 or x2.shape[1:3] != (h_x2, w) or n % x2.shape[0]:
            raise ValueError(f"x2 must be [N2, {h_x2}, {w}, C2] with N % N2 "
                             f"== 0, got {tuple(x2.shape)}")
        if x2_half_h and (h % 2 or h < 4):
            raise ValueError("x2_half_h needs an even H >= 4")
    elif x2_half_h:
        raise ValueError("x2_half_h needs x2")
    if (wo is None) != (bo is None):
        raise ValueError("wo and bo come together")
    if wo is not None:
        if wo.ndim != 3 or wo.shape[:2] != (g, o) or tuple(bo.shape) != (g, wo.shape[2]):
            raise ValueError("wo must be [G, O, OC] and bo [G, OC]")
        if emit_hpool or group_rows_out:
            raise ValueError("the fused out-conv excludes hpool and group_rows_out")
    if emit_hpool and h % 2:
        raise ValueError("emit_hpool needs an even H")


def fused_double_conv_plain(x1, w1, s1, sh1, w2, s2, sh2, *, x2=None,
                            x2_half_h=False, wo=None, bo=None,
                            emit_hpool=False, group_rows_out=False):
    """Plain PyTorch version of ``fused_double_conv`` (same arguments and
    results): f32 convs on bf16-rounded operands, rounded where the kernel
    rounds."""
    _check(x1, w1, s1, sh1, w2, s2, sh2, x2, x2_half_h, wo, bo, emit_hpool,
           group_rows_out)
    n, h, w, _ = x1.shape
    g = w1.shape[0]
    per = n // g
    x = x1.float()
    if x2 is not None:
        xb = lerp_h2x_plain(x2) if x2_half_h else x2
        # image n reads x2 image n % N2
        xb = xb.float().repeat(n // x2.shape[0], 1, 1, 1)
        x = torch.cat([x, xb], dim=-1)
    x = x.permute(0, 3, 1, 2)
    ys = []
    for gi in range(g):
        y = _conv3x3_reflect_f32(x[gi * per:(gi + 1) * per], w1[gi])
        y = torch.relu(y * s1[gi].float().view(1, -1, 1, 1)
                       + sh1[gi].float().view(1, -1, 1, 1))
        y = _conv3x3_reflect_f32(_as_bf16_f32(y), w2[gi])
        ys.append(torch.relu(y * s2[gi].float().view(1, -1, 1, 1)
                             + sh2[gi].float().view(1, -1, 1, 1)))
    y2 = torch.cat(ys).permute(0, 2, 3, 1).to(BF16)  # [N, H, W, O]
    if wo is not None:
        logits = [y2[gi * per:(gi + 1) * per].float() @ _as_bf16_f32(wo[gi])
                  + bo[gi].float() for gi in range(g)]
        return torch.cat(logits).to(BF16)
    hp = torch.maximum(y2[:, 0::2], y2[:, 1::2]) if emit_hpool else None
    if group_rows_out:
        y2 = _group_rows(y2, g)
        hp = _group_rows(hp, g) if emit_hpool else None
    return (y2.contiguous(), hp.contiguous()) if emit_hpool else y2.contiguous()


def _launch(x1, w1, s1, sh1, w2, s2, sh2, x2, x2_half_h, wo, bo, emit_hpool,
            group_rows_out, fixed_cin):
    """Pack the weights as the kernel reads them and launch it."""
    n, h, w, c1 = x1.shape
    g, m, o = w1.shape[0], w1.shape[4], w2.shape[4]
    c2 = 0 if x2 is None else x2.shape[-1]
    mp, op = -(-m // 8) * 8, -(-o // 8) * 8
    dev = x1.device

    def pad(t, k):  # last dim -> k, zeros
        return F.pad(t, (0, k - t.shape[-1])).contiguous()

    w1k = pad(w1.reshape(g, 9, c1 + c2, m).to(BF16), mp)
    w2k = pad(w2.reshape(g, 9, m, o).to(BF16), op)
    s1k, sh1k = pad(s1.float(), mp), pad(sh1.float(), mp)
    s2k, sh2k = pad(s2.float(), op), pad(sh2.float(), op)
    tensors = [x1, w1k, s1k, sh1k, w2k, s2k, sh2k]
    oc = 0
    if wo is not None:
        oc = wo.shape[2]
        wo = wo.to(BF16).contiguous()
        bo = bo.float().contiguous()
        tensors += [wo, bo]
    if x2 is not None:
        tensors.append(x2)
    _build.require_cuda(*tensors)
    for t in [x1] + ([x2] if x2 is not None else []):
        if t.dtype != BF16:
            raise TypeError(f"activations must be bf16, got {t.dtype}")

    hp = None
    if group_rows_out:
        out = torch.empty((n // g, h, w, g * o), device=dev, dtype=BF16)
        if emit_hpool:
            hp = torch.empty((n // g, h // 2, w, g * o), device=dev, dtype=BF16)
    else:
        out = torch.empty((n, h, w, oc or o), device=dev, dtype=BF16)
        if emit_hpool:
            hp = torch.empty((n, h // 2, w, o), device=dev, dtype=BF16)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lo_h = fb = None
    if x2_half_h:
        lo_h, _, fb, _ = _h_tables(h // 2, dev)
    _build.launch(
        "mimo_fused_double_conv", dev,
        ptr(x1), ptr(x2), ptr(w1k), ptr(s1k), ptr(sh1k), ptr(w2k), ptr(s2k),
        ptr(sh2k), ptr(wo), ptr(bo), ptr(out), ptr(hp), ptr(lo_h), ptr(fb),
        n, h, w, c1, c2, 0 if x2 is None else x2.shape[0], int(x2_half_h),
        m, o, oc, g, int(group_rows_out), fixed_cin)
    return (out, hp) if emit_hpool else out


def fused_double_conv(x1: torch.Tensor, w1: torch.Tensor, s1: torch.Tensor,
                      sh1: torch.Tensor, w2: torch.Tensor, s2: torch.Tensor,
                      sh2: torch.Tensor, *, x2: Optional[torch.Tensor] = None,
                      x2_half_h: bool = False,
                      wo: Optional[torch.Tensor] = None,
                      bo: Optional[torch.Tensor] = None,
                      emit_hpool: bool = False, group_rows_out: bool = False):
    """The fused DoubleConv (K1).

    x1: [N, H, W, C1] bf16.  x2: optional second concat input
    [N2, H, W, C2] (or [N2, H/2, W, C2] with ``x2_half_h``: the H half of
    the bilinear x2 upsample runs in-kernel); image n reads x2 image
    n % N2.  w1 [G, 3, 3, C1+C2, M], s1/sh1 [G, M], w2 [G, 3, 3, M, O],
    s2/sh2 [G, O]; wo [G, O, OC], bo [G, OC]: fused 1x1 out-conv.

    Returns [N, H, W, O] bf16 (or [N, H, W, OC] logits with ``wo``; or
    [N/G, H, W, G*O] with ``group_rows_out``), plus with ``emit_hpool`` the
    row-pair max [N, H/2, W, O] (same grouping).  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise.
    """
    if x1.device.type == "cpu":
        return fused_double_conv_plain(
            x1, w1, s1, sh1, w2, s2, sh2, x2=x2, x2_half_h=x2_half_h, wo=wo,
            bo=bo, emit_hpool=emit_hpool, group_rows_out=group_rows_out)
    _check(x1, w1, s1, sh1, w2, s2, sh2, x2, x2_half_h, wo, bo, emit_hpool,
           group_rows_out)
    out = _launch(x1, w1, s1, sh1, w2, s2, sh2, x2, x2_half_h, wo, bo,
                  emit_hpool, group_rows_out, fixed_cin=0)
    fused_double_conv.launches += 1
    return out


def fused_double_conv9_plain(x, w1, s1, sh1, w2, s2, sh2, *, emit_hpool=False):
    """Plain PyTorch version of ``fused_double_conv9``."""
    return fused_double_conv_plain(x, w1, s1, sh1, w2, s2, sh2,
                                   emit_hpool=emit_hpool)


def fused_double_conv9(x: torch.Tensor, w1: torch.Tensor, s1: torch.Tensor,
                       sh1: torch.Tensor, w2: torch.Tensor, s2: torch.Tensor,
                       sh2: torch.Tensor, *, emit_hpool: bool = False):
    """The fused DoubleConv for C_in <= 8, the network's in_conv (K2): one
    input, conv1's channel loop unrolled for the exact C_in.  Arguments and
    results as ``fused_double_conv``."""
    if x.ndim != 4 or not 1 <= x.shape[-1] <= 8:
        raise ValueError(f"fused_double_conv9 takes [N, H, W, C<=8], got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return fused_double_conv9_plain(x, w1, s1, sh1, w2, s2, sh2,
                                        emit_hpool=emit_hpool)
    _check(x, w1, s1, sh1, w2, s2, sh2, None, False, None, None, emit_hpool,
           False)
    out = _launch(x, w1, s1, sh1, w2, s2, sh2, None, False, None, None,
                  emit_hpool, False, fixed_cin=x.shape[-1])
    fused_double_conv9.launches += 1
    return out


fused_double_conv.launches = 0
fused_double_conv9.launches = 0
