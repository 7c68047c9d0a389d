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

The kernel runs both convs on the tensor cores from tiles staged in shared
memory (the source's header says how).  What it takes from the host is
built here, where the CPU tests reach it: the launch plan (``plan_of``:
the output tile, conv1's input channel slices or its (tap, channel) fold,
the mid's slices, the warp grids and passes of both convs, the shared
memory they need) and the weights packed for it (``pack_weights``).  A
channel count no plan fits raises, naming the limit: the eval route plans
each of its sites before it takes a forward (``fast_path.check_eval_plans``).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from mimo_unet_torch.kernels import _build
from mimo_unet_torch.kernels.upsample2x import _h_tables

BF16 = torch.bfloat16
MTW, NTW = 3, 6        # mma m-tiles (16 pixels) and n-tiles (8 channels) a warp holds
CMAX = (64, 32, 16)    # channel slice widths tried, widest first
SMEM_MAX = 232448      # dynamic shared memory of one H100 block
SMEM_TWO = 113 * 1024  # ... of each of two blocks on one multiprocessor
# (shared memory limit, output tile rows x columns, warps a block) in the
# order plan_of tries them: two blocks of eight warps a multiprocessor
# first, then one of sixteen, then one of eight (whose narrower warp grid
# may take more passes over conv1's K, but fits where sixteen's wider
# weight chunks do not); the larger tiles first (the mid's recompute 1.27x
# at 16x16, 1.33x at 8x32, 1.41x at 8x16).  Im2col plans (C_in <= 7) take
# 8x32 before 16x16.  Chosen by measurement (tools/fused_tc_plans.py;
# PERF.md).
TILES = ((16, 16), (8, 32), (8, 16))
PLAN_ORDER = tuple((lim, tile, warps) for lim, warps in (
    (SMEM_TWO, 8), (SMEM_MAX, 16), (SMEM_MAX, 8)) for tile in TILES)


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


# ---------------------------------------------------------------- the plan

def _up(a: int, b: int) -> int:
    return -(-a // b) * b


def _stride8(c: int) -> int:
    """Row stride (elements) of a staged tile of c (a multiple of 8)
    channels: an odd number of 16-byte units (ldmatrix without bank
    conflicts)."""
    return 8 * ((c // 8) | 1)


def _run_bytes(px: int, c: int) -> int:
    """Raw bytes of one run of px pixels of c bf16 channels copied in
    16-byte units from any element offset."""
    return 16 * ((px * c * 2 + 15) // 16 + 1)


@dataclasses.dataclass(frozen=True)
class FdcPlan:
    """A launch of the fused DoubleConv kernel: ``th`` x ``tw`` output
    tiles; conv1's K in ``ncs`` slices of ``cb`` input channels (or, with
    ``im2col``, the (tap, channel) pairs padded to ``cb``); its N (the mid
    channels) in ``np1`` passes of ``nb1`` over a warp grid with ``wn1``
    warps along N; conv2's K (the mid) in ``ncs2`` slices of ``cb2`` and
    its N in ``np2`` passes of ``nb2`` (``wn2``); ``warps`` a block (8
    where two blocks fit a multiprocessor, else 16 or 8); ``smem`` bytes
    of dynamic shared memory (the source's ``layout``)."""
    th: int
    tw: int
    im2col: bool
    cb: int
    ncs: int
    nb1: int
    np1: int
    wn1: int
    cb2: int
    ncs2: int
    nb2: int
    np2: int
    wn2: int
    warps: int
    smem: int

    @property
    def ws1(self) -> int:
        return _stride8(self.nb1)

    @property
    def ws2(self) -> int:
        return _stride8(self.nb2)


def _warp_grid(px: int, nch: int, warps: int) -> Optional[int]:
    """Warps along N of a conv with ``px`` pixels and ``nch`` output
    channels in a block of ``warps``: the fewest (1, 2, 4, ...) that hold
    every n-tile in one pass, as far as the m-tiles still fit the warps
    along M (MTW each); None if even one warp along N leaves too many
    m-tiles."""
    mt, nt = -(-px // 16), -(-nch // 8)
    best = None
    for wn in (1, 2, 4, 8, 16)[:warps.bit_length()]:
        if -(-mt // (warps // wn)) > MTW:
            break
        best = wn
        if wn * NTW >= nt:
            break
    return best


def _smem(th, tw, c1, c2, o, im2col, cb, ncs, nb1, cb2, mp2, nb2) -> int:
    """The source's ``layout``: two weight buffers, the mid, the slab (the
    output tile in its place), the raw runs."""
    a16 = lambda b: _up(b, 16)  # noqa: E731
    srows, scols, mid_px = th + 4, tw + 4, (th + 2) * (tw + 2)
    chunk1 = (cb if im2col else 9 * cb) * _stride8(nb1)
    chunk2 = 9 * cb2 * _stride8(nb2)
    rowrun = ncs == 1
    rx1 = _run_bytes(scols, c1) if rowrun else _run_bytes(1, min(cb, c1))
    rx2 = 0 if c2 == 0 else (_run_bytes(scols, c2) if rowrun
                             else _run_bytes(1, min(cb, c2)))
    rpr = 1 if rowrun else scols
    z = a16((mid_px if im2col else srows * scols) * _stride8(cb) * 2)
    return (2 * 2 * max(chunk1, chunk2) + a16(mid_px * _stride8(mp2) * 2)
            + max(z, a16(th * tw * o * 2)) + srows * rpr * (rx1 + rx2))


def plans(c1: int, c2: int, m: int, o: int):
    """Every launch of the kernel for C_in = c1 + c2 -> M -> O, in the
    order ``plan_of`` prefers them: ``PLAN_ORDER``'s (shared memory limit,
    tile, warps; im2col plans swap its first two), and within each the
    widest channel slices that fit.  At C_in <= 7 without x2 conv1 folds (tap,
    channel) into one K of 9*C_in padded to 16."""
    cin = c1 + c2
    im2col = c2 == 0 and 9 * c1 <= 64
    slices1 = [(1, _up(9 * c1, 16))] if im2col else [
        (-(-cin // cm), _up(-(-cin // -(-cin // cm)), 16)) for cm in CMAX]
    order = PLAN_ORDER[1::-1] + PLAN_ORDER[2:] if im2col else PLAN_ORDER
    for lim, (th, tw), warps in order:
        wn1 = _warp_grid((th + 2) * (tw + 2), m, warps)
        wn2 = _warp_grid(th * tw, o, warps)
        if wn1 is None or wn2 is None:
            continue
        nb1, nb2 = min(_up(m, 8), wn1 * NTW * 8), min(_up(o, 8), wn2 * NTW * 8)
        for ncs, cb in slices1:
            for cm2 in CMAX:
                ncs2 = -(-m // cm2)
                cb2 = _up(-(-m // ncs2), 16)
                smem = _smem(th, tw, c1, c2, o, im2col, cb, ncs, nb1, cb2,
                             ncs2 * cb2, nb2)
                if smem <= lim:
                    yield FdcPlan(th, tw, im2col, cb, ncs, nb1, -(-m // nb1), wn1,
                                  cb2, ncs2, nb2, -(-o // nb2), wn2, warps, smem)


@lru_cache(maxsize=64)
def plan_of(c1: int, c2: int, m: int, o: int) -> FdcPlan:
    """The kernel's launch for C_in = c1 + c2 -> M -> O: the first of
    ``plans``.  It does not depend on x2_half_h, H, W or N.  Raises
    ValueError, naming the limit, where nothing fits."""
    for plan in plans(c1, c2, m, o):
        return plan
    raise ValueError(f"the fused DoubleConv kernel takes at most {SMEM_MAX} bytes "
                     f"of shared memory a block; {c1 + c2} -> {m} -> {o} channels "
                     f"need more in every plan")


def pack_weights(w1: torch.Tensor, w2: torch.Tensor, plan: FdcPlan) -> torch.Tensor:
    """[G, 3, 3, C_in, M] and [G, 3, 3, M, O] -> the kernel's [G, wtot]
    bf16: conv1's chunks, pass-major, each [9][cb][ws1] (im2col: [cb][ws1],
    row tap * C_in + c) of its k-slice and pass, then conv2's, each
    [9][cb2][ws2]; zeros in every padding (a chunk is a flat copy into
    shared memory, the B operand of its step)."""
    g, _, _, cin, m = w1.shape
    o = w2.shape[4]
    p = plan
    if p.im2col:
        a = F.pad(w1.to(BF16).reshape(g, 9 * cin, m),
                  (0, p.np1 * p.nb1 - m, 0, p.cb - 9 * cin))
        a = F.pad(a.reshape(g, p.cb, p.np1, p.nb1), (0, p.ws1 - p.nb1))
        a = a.permute(0, 2, 1, 3)
    else:
        a = F.pad(w1.to(BF16).reshape(g, 9, cin, m),
                  (0, p.np1 * p.nb1 - m, 0, p.ncs * p.cb - cin))
        a = F.pad(a.reshape(g, 9, p.ncs, p.cb, p.np1, p.nb1), (0, p.ws1 - p.nb1))
        a = a.permute(0, 4, 2, 1, 3, 5)
    b = F.pad(w2.to(BF16).reshape(g, 9, m, o),
              (0, p.np2 * p.nb2 - o, 0, p.ncs2 * p.cb2 - m))
    b = F.pad(b.reshape(g, 9, p.ncs2, p.cb2, p.np2, p.nb2), (0, p.ws2 - p.nb2))
    b = b.permute(0, 4, 2, 1, 3, 5)
    return torch.cat([a.reshape(g, -1), b.reshape(g, -1)], 1).contiguous()


def unpack_weights(wpk: torch.Tensor, plan: FdcPlan, cin: int, m: int, o: int):
    """Inverse of ``pack_weights``: -> (w1 [G, 3, 3, C_in, M], w2
    [G, 3, 3, M, O])."""
    g, p = wpk.shape[0], plan
    rows1 = p.cb if p.im2col else 9 * p.cb
    n1 = p.np1 * p.ncs * rows1 * p.ws1
    a, b = wpk[:, :n1], wpk[:, n1:]
    if p.im2col:
        a = a.reshape(g, p.np1, p.cb, p.ws1)[..., :p.nb1].permute(0, 2, 1, 3)
        w1 = a.reshape(g, p.cb, -1)[:, :9 * cin, :m].reshape(g, 3, 3, cin, m)
    else:
        a = a.reshape(g, p.np1, p.ncs, 9, p.cb, p.ws1)[..., :p.nb1]
        a = a.permute(0, 3, 2, 4, 1, 5).reshape(g, 9, p.ncs * p.cb, -1)
        w1 = a[:, :, :cin, :m].reshape(g, 3, 3, cin, m)
    b = b.reshape(g, p.np2, p.ncs2, 9, p.cb2, p.ws2)[..., :p.nb2]
    b = b.permute(0, 3, 2, 4, 1, 5).reshape(g, 9, p.ncs2 * p.cb2, -1)
    return w1, b[:, :, :m, :o].reshape(g, 3, 3, m, o)


def _blocks(plan: FdcPlan, tiles: int, device: torch.device) -> int:
    """The grid: one block for each slot the card has for it (two of eight
    warps a multiprocessor where the plan leaves room, else one), each
    taking every blocks-th tile; on the CPU (the tests' emulation) two
    multiprocessors, so a block takes several tiles."""
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device.type == "cuda" else 2)
    return min(tiles, sms * (2 if plan.warps == 8 and plan.smem <= SMEM_TWO else 1))


def kernel_args(x1, w1, s1, sh1, w2, s2, sh2, x2, x2_half_h, wo, bo, emit_hpool,
                group_rows_out, plan: Optional[FdcPlan] = None):
    """What the wrapper hands the kernel, on the inputs' device: (plan, the
    entry's arguments but the stream, the outputs (out, hpool or None), the
    tensors the pointers refer to).  ``plan``: ``plan_of``'s unless given."""
    n, h, w, c1 = x1.shape
    g, m, o = w1.shape[0], w1.shape[4], w2.shape[4]
    c2 = 0 if x2 is None else x2.shape[-1]
    dev = x1.device
    plan = plan or plan_of(c1, c2, m, o)
    # the kernel copies 16-byte units: packed weights and activations
    # 16-byte aligned
    x1 = x1.contiguous() if x1.data_ptr() % 16 == 0 else x1.clone()
    if x2 is not None:
        x2 = x2.contiguous() if x2.data_ptr() % 16 == 0 else x2.clone()
    keep = [x1, x2, pack_weights(w1, w2, plan), s1.float().contiguous(),
            sh1.float().contiguous(), s2.float().contiguous(), sh2.float().contiguous()]
    oc = 0
    if wo is not None:
        oc = wo.shape[2]
        keep += [wo.to(BF16).contiguous(), bo.float().contiguous()]
    else:
        keep += [None, None]
    hp = None
    if group_rows_out:
        out = torch.empty((n // g, h, w, g * o), device=dev, dtype=BF16)
        if emit_hpool:
            hp = torch.empty((n // g, h // 2, w, g * o), device=dev, dtype=BF16)
    else:
        out = torch.empty((n, h, w, oc or o), device=dev, dtype=BF16)
        if emit_hpool:
            hp = torch.empty((n, h // 2, w, o), device=dev, dtype=BF16)
    keep += [out, hp]
    keep += list(_h_tables(h // 2, dev)[:3]) if x2_half_h else [None] * 3
    args = [None if t is None else t.data_ptr() for t in keep]
    args += [n, h, w, c1, c2, 0 if x2 is None else x2.shape[0], int(x2_half_h), m, o,
             oc, g, int(group_rows_out), plan.th, plan.tw, int(plan.im2col), plan.cb,
             plan.nb1, plan.wn1, plan.cb2, plan.nb2, plan.wn2, 32 * plan.warps,
             _blocks(plan, n * -(-h // plan.th) * -(-w // plan.tw), dev)]
    return plan, args, (out, hp), keep


def _launch(x1, w1, s1, sh1, w2, s2, sh2, x2, x2_half_h, wo, bo, emit_hpool,
            group_rows_out):
    """Plan the launch, pack the weights as the kernel reads them and
    launch it."""
    for t in [x1] + ([x2] if x2 is not None else []):
        if t.dtype != BF16:
            raise TypeError(f"activations must be bf16, got {t.dtype}")
    _build.require_cuda(*[t.contiguous() for t in (x1, x2, w1, s1, sh1, w2, s2, sh2,
                                                   wo, bo) if t is not None])
    _, args, (out, hp), _ = kernel_args(x1, w1, s1, sh1, w2, s2, sh2, x2, x2_half_h,
                                        wo, bo, emit_hpool, group_rows_out)
    _build.launch("mimo_fused_double_conv", x1.device, *args)
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
                  emit_hpool, group_rows_out)
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
    input; at C_in <= 7 conv1 folds (tap, channel) into one K of 9*C_in
    padded to 16.  Arguments and results as ``fused_double_conv``."""
    if x.ndim != 4 or not 1 <= x.shape[-1] <= 8:
        raise ValueError(f"fused_double_conv9 takes [N, H, W, C<=8], got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return fused_double_conv9_plain(x, w1, s1, sh1, w2, s2, sh2,
                                        emit_hpool=emit_hpool)
    _check(x, w1, s1, sh1, w2, s2, sh2, None, False, None, None, emit_hpool,
           False)
    out = _launch(x, w1, s1, sh1, w2, s2, sh2, None, False, None, None,
                  emit_hpool, False)
    fused_double_conv9.launches += 1
    return out


fused_double_conv.launches = 0
fused_double_conv9.launches = 0
