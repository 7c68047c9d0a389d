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

``x2_half_h`` (the forward and dw; ``_x2_half_spec`` :238,
``_stage_x2_half`` :255): x2 arrives at half height ``[N2, H/2, W, C2]``,
only the W half of its bilinear x2 upsample applied (``upsample_w2x``,
K4), and the kernels lerp its rows as they stage it, with the x2
upsample's row tables and operation order (``upsample2x._h_tables``;
``fused_double_conv.lerp_h2x_plain`` in the plain versions): y, its
statistics and dw are bit for bit those of the full-res x2 that
``upsample2x`` (K13) would have written, and that tensor never exists.
``Conv3x3Train``'s backward then takes the fold dx's full-res x2
cotangent to half height with ``lerp_h2x_transpose`` (K14), as
``_train_bwd_rule`` does (:1236-1246); the W transpose is
``UpsampleW2x``'s own backward (K4b).  The prologue and the plain dx form
never take it (:1200-1201).

Layouts on the card (the CT layout, align8 padding and tile ladders are TPU
constraints and are not ported): activations channels-last bf16
``[N, H, W, C]`` with the groups folded S-major into N (image n uses group
n // (N / G)); weights HWIO per group ``[G, 3, 3, C_in, O]``; prologue
scale/shift f32 ``[G, C_in]``.  The kernels take any H, W >= 3: an
image's last tile may be partial.

K5, K6 and K7 run on the tensor cores from spatial tiles staged in shared
memory (``csrc/conv3x3_train.cu``).  What they take from the host is built
here, where the CPU tests reach it: the tile plan (``fwd_plan``,
``dx_plan``, ``dw_plan``: tile rows, channel and output slices, tiles per
block, the partial counts and the shared memory they need), K5's and K6's
packed weights (``pack_fwd_weights``, ``pack_dx_weights``) and the
reflect-fold tables of K6's rows and columns (``fold_table``);
``dz_folds`` is the plain torch form of K6's sum, the zero-pad full conv
plus one term per fold.

Rounding points (both versions): bf16 operands, f32 accumulation; z
computed in f32 and rounded to bf16 (ct_train.py:151-156); y rounded to
bf16 and its statistics taken of the rounded values (:220-224); dx rounded
once; the fold's per-image x2 cotangents rounded, summed in f32, rounded
(:533-556); dw in f32.  The plain versions compute the transposes by
autograd through an f32 reflect conv.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from mimo_unet_torch.kernels import _build
from mimo_unet_torch.kernels.fused_double_conv import (
    _run_bytes,
    _stride8,
    _up,
    lerp_h2x_plain,
)
from mimo_unet_torch.kernels.train_elem import (
    g_eff,
    group_sum,
    per_image,
    reduce_groups,
)
from mimo_unet_torch.kernels.upsample2x import _h_tables, lerp_h2x_transpose
from mimo_unet_torch.train.profiling import span

BF16 = torch.bfloat16
TW = 16               # K5/K6/K7 tile columns (the halo tile has TW + 2)
MAX_C = 256           # 3x3 conv channels in and out of the train kernels
                      # (their entries' limit)
SMEM_MAX = 232448     # dynamic shared memory of one H100 block
SMEM_TWO = 113 * 1024  # ... of each of two blocks on one multiprocessor
DW_BLOCKS = 528       # K7 blocks aimed at: 132 multiprocessors x 4
DX_SPAN = 4           # K6 tiles per block
FWD_SPAN = 8          # K5 tiles per block at most, fewer where that
FWD_BLOCKS = 2112     # leaves under 132 multiprocessors x 2 x 8 blocks


def _check(x1, w, x2, scale, shift, x2_half_h=False) -> Tuple[int, int, int]:
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
    if x2_half_h and (x2 is None or scale is not None or h % 2 or h < 4):
        raise ValueError("x2_half_h needs x2, no prologue and an even H >= 4")
    h2 = h // 2 if x2_half_h else h
    if x2 is not None and (x2.ndim != 4 or x2.shape[1:3] != (h2, w_)
                           or n % x2.shape[0]):
        raise ValueError(f"x2 must be [N2, {h2}, {w_}, C2] with N % N2 == 0, "
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


# ---------------------------------------------------------------- K5/K6/K7 plans

@dataclasses.dataclass(frozen=True)
class TilePlan:
    """A K5/K6/K7 launch: tiles of ``th`` rows by ``TW`` columns; channel
    slices of ``cb`` (``ncs`` of them; K5's K, K7's M, K6's N); K5's and
    K7's output slices of ``nb`` (``nos``) and their (tap, channel) fold
    (``im2col``, padded to ``mp``); ``span`` tiles per block; ``chunks``
    blocks per group (K7: the partial rows of a group) or per image (K5,
    K6); ``smem`` bytes of dynamic shared memory (the layouts
    ``fwd_layout``, ``dw_layout`` and ``dx_layout`` of the source)."""
    th: int
    tiles_w: int
    tpi: int
    cb: int
    ncs: int
    nb: int
    nos: int
    im2col: bool
    mp: int
    span: int
    chunks: int
    smem: int


def _fwd_smem(th, c1, c2, cb, ncs, nb, im2col, mp) -> int:
    rows = th + 2
    a16 = lambda b: _up(b, 16)  # noqa: E731
    wrows = mp if im2col else 9 * ncs * cb
    z = (th * TW if im2col else rows * (TW + 2)) * _stride8(mp if im2col else cb) * 2
    raw2 = _run_bytes(TW + 2, c2) if c2 else 0
    return (wrows * _stride8(nb) * 2 + a16(z) + rows * _run_bytes(TW + 2, c1)
            + rows * 2 * raw2 + a16(4 * rows * 4) + 2 * _up(c1, 8) * 4 + 2 * 8 * nb * 4)


def _dw_smem(th, c1, c2, o, cb, nb, im2col, mp) -> int:
    rows = th + 2
    a16 = lambda b: _up(b, 16)  # noqa: E731
    z = (th * TW if im2col else rows * (TW + 2)) * _stride8(mp if im2col else cb) * 2
    raw2 = _run_bytes(TW + 2, c2) if c2 else 0
    return (a16(z) + a16(th * TW * _stride8(nb) * 2) + rows * _run_bytes(TW + 2, c1)
            + rows * 2 * raw2 + th * _run_bytes(TW, o) + a16((4 * rows + th) * 4)
            + 2 * _up(c1, 8) * 4)


def _dx_smem(th, o, cb) -> int:
    rows, ws = th + 2, _stride8(_up(o, 16))
    return (9 * cb * ws * 2 + rows * (TW + 2) * ws * 2
            + rows * _run_bytes(TW + 2, o) + _up(rows * 4, 16) + 2 * 9 * cb * 4 + 16)


def _pick_th(smem_of) -> Optional[int]:
    """The tallest tile that leaves room for two blocks a multiprocessor,
    else the tallest that fits one."""
    for limit in (SMEM_TWO, SMEM_MAX):
        for th in (8, 4, 2, 1):
            if smem_of(th) <= limit:
                return th
    return None


def _limit(cin: int, o: int) -> None:
    if cin > MAX_C or o > MAX_C:
        raise ValueError(f"the train conv kernels take at most {MAX_C} input "
                         f"and output channels, got {cin} -> {o}")


def _slices(cin: int) -> Tuple[bool, int, int, int]:
    """The staged z's channels, as K5 and K7 take them: (im2col, cb, ncs,
    mp).  At C_in <= 7 the (tap, channel) pairs fold into one dimension of
    9*C_in padded to 16; else slices of at most 64 channels padded to 16."""
    if 9 * cin <= 64:
        return True, 16, 1, _up(9 * cin, 16)
    ncs = -(-cin // 64)
    return False, _up(-(-cin // ncs), 16), ncs, 0


def fwd_plan(n: int, h: int, w: int, c1: int, c2: int, o: int) -> TilePlan:
    """K5's launch.  Eight warps, one per tile row, each with up to 8 mma
    n-tiles: output slices of at most 64 (narrower where the weights need
    the room), every channel slice inside the block; blocks of up to
    ``FWD_SPAN`` tiles of one image, fewer where that would leave fewer
    than ``FWD_BLOCKS`` blocks.  The plan does not depend on x2_half_h:
    both forms take the same tiles and sum in the same order."""
    cin = c1 + c2
    _limit(cin, o)
    im2col, cb, ncs, mp = _slices(cin)
    # output slice widths, widest first: o in 1, 2, ... slices of at most
    # 64, each padded to whole n-tiles
    widths = sorted({_up(-(-o // k), 8) for k in range(-(-o // 64), -(-o // 8) + 1)},
                    reverse=True)
    for limit in (SMEM_TWO, SMEM_MAX):
        for th in (8, 4, 2, 1):
            for nb in widths:
                smem = _fwd_smem(th, c1, c2, cb, ncs, nb, im2col, mp)
                if smem <= limit:
                    tiles_w = -(-w // TW)
                    tpi = -(-h // th) * tiles_w
                    nos = -(-o // nb)
                    span = min(FWD_SPAN, tpi, max(1, -(-(n * tpi * nos) // FWD_BLOCKS)))
                    return TilePlan(th, tiles_w, tpi, cb, ncs, nb, nos, im2col,
                                    mp, span, -(-tpi // span), smem)
    raise ValueError(f"conv3x3_fwd: {cin} -> {o} channels need more than "
                     f"{SMEM_MAX} bytes of shared memory")


def pack_fwd_weights(w: torch.Tensor, plan: TilePlan) -> torch.Tensor:
    """[G, 3, 3, C, O] -> K5's [G, nos, K, ws] bf16: per output slice, the
    weights [k][o] with k = tap * ncs*cb + c (im2col: tap * C + c, padded to
    mp) and o padded to the staged row stride ws, zeros in the padding (a
    flat copy of one slice is K5's shared-memory B operand)."""
    groups, _, _, c, o = w.shape
    ws = _stride8(plan.nb)
    wt = w.to(BF16).reshape(groups, 9, c, o)
    if plan.im2col:
        wt = F.pad(wt.reshape(groups, 9 * c, o), (0, 0, 0, plan.mp - 9 * c))
    else:
        wt = F.pad(wt, (0, 0, 0, plan.ncs * plan.cb - c)).reshape(groups, -1, o)
    wt = F.pad(wt, (0, plan.nos * plan.nb - o)).reshape(groups, -1, plan.nos, plan.nb)
    return F.pad(wt, (0, ws - plan.nb)).transpose(1, 2).contiguous()


def unpack_fwd_weights(wpk: torch.Tensor, plan: TilePlan, c: int, o: int) -> torch.Tensor:
    """Inverse of ``pack_fwd_weights``: -> [G, 3, 3, C, O]."""
    groups = wpk.shape[0]
    wt = wpk[..., :plan.nb].transpose(1, 2).reshape(groups, wpk.shape[2], -1)[..., :o]
    if plan.im2col:
        return wt[:, :9 * c].reshape(groups, 3, 3, c, o)
    return wt.reshape(groups, 9, -1, o)[:, :, :c].reshape(groups, 3, 3, c, o)


def dw_plan(n: int, h: int, w: int, c1: int, c2: int, o: int,
            groups: int) -> TilePlan:
    """K7's launch.  Nine warps, one per tap, each holding up to 4 x 4 mma
    tiles: channel slices of at most 64 (M) and output slices of at most
    32 (N); at C_in <= 7 the (tap, channel) pairs fold into one M of
    9*C_in padded to 16.  Chunks of ``span`` tiles of one group: about
    ``DW_BLOCKS`` blocks in all, each writing one partial row."""
    cin = c1 + c2
    _limit(cin, o)
    im2col, cb, ncs, mp = _slices(cin)
    nos = -(-o // 32)
    nb = _up(-(-o // nos), 8)
    th = _pick_th(lambda t: _dw_smem(t, c1, c2, o, cb, nb, im2col, mp))
    if th is None:
        raise ValueError(f"conv3x3_dw: {cin} -> {o} channels need more than "
                         f"{SMEM_MAX} bytes of shared memory")
    tiles_w = -(-w // TW)
    tpi = -(-h // th) * tiles_w
    tiles = n // groups * tpi
    want = min(tiles, max(1, -(-DW_BLOCKS // (groups * ncs * nos))))
    span = -(-tiles // want)
    return TilePlan(th, tiles_w, tpi, cb, ncs, nb, nos, im2col, mp, span,
                    -(-tiles // span),
                    _dw_smem(th, c1, c2, o, cb, nb, im2col, mp))


def dx_plan(h: int, w: int, o: int, cin: int) -> TilePlan:
    """K6's launch.  Eight warps, one per tile row, each with up to 8 mma
    n-tiles: channel slices of at most 64 (narrower where the weights need
    the room); blocks of ``DX_SPAN`` tiles of one image."""
    _limit(cin, o)
    for limit in (SMEM_TWO, SMEM_MAX):
        for cmax in (64, 32, 16, 8):
            ncs = -(-cin // cmax)
            cb = _up(-(-cin // ncs), 8)
            for th in (8, 4, 2, 1):
                if _dx_smem(th, o, cb) <= limit:
                    tiles_w = -(-w // TW)
                    tpi = -(-h // th) * tiles_w
                    return TilePlan(th, tiles_w, tpi, cb, ncs, 0, 0, False, 0,
                                    DX_SPAN, -(-tpi // DX_SPAN),
                                    _dx_smem(th, o, cb))
    raise ValueError(f"conv3x3_dx: {cin} <- {o} channels need more than "
                     f"{SMEM_MAX} bytes of shared memory")


def pack_dx_weights(w: torch.Tensor, plan: TilePlan) -> torch.Tensor:
    """[G, 3, 3, C, O] -> K6's [G, ncs, 9, cb, ws] bf16: per channel slice
    and tap, the weights [channel][o] with o padded to the staged row
    stride ws, zeros in the padding (a flat copy of one slice is K6's
    shared-memory B operand)."""
    groups, _, _, c, o = w.shape
    ws = _stride8(_up(o, 16))
    wt = F.pad(w.to(BF16).reshape(groups, 9, c, o),
               (0, ws - o, 0, plan.ncs * plan.cb - c))
    return wt.reshape(groups, 9, plan.ncs, plan.cb, ws).transpose(1, 2).contiguous()


def unpack_dx_weights(wpk: torch.Tensor, c: int, o: int) -> torch.Tensor:
    """Inverse of ``pack_dx_weights``: -> [G, 3, 3, C, O]."""
    groups, ncs, _, cb, ws = wpk.shape
    wt = wpk.transpose(1, 2).reshape(groups, 9, ncs * cb, ws)[:, :, :c, :o]
    return wt.reshape(groups, 3, 3, c, o)


def fold_table(size: int, device=None) -> torch.Tensor:
    """The reflect folds of one axis of K6, int32 [size]: bit 0 of entry 1
    (g at 0 reaches it through tap 0), bit 1 of entry size - 2 (g at size
    - 1, through tap 2).  At size 3 both fall on entry 1."""
    t = torch.zeros(size, dtype=torch.int32)
    t[1] |= 1
    t[size - 2] |= 2
    return t.to(device) if device is not None else t


def dz_folds(g: torch.Tensor, w: torch.Tensor, frow: torch.Tensor,
             fcol: torch.Tensor) -> torch.Tensor:
    """K6's sum in plain torch: [N, H, W, O] -> [N, H, W, C] f32, the
    zero-pad full conv of g with the transposed taps plus, for each tap
    and pixel the fold tables name, the mirrored tap's single g value
    through this tap's weights (a row fold, a column fold, both), each
    term a product of one g value and one weight, summed in f32."""
    n, h, wd, o = g.shape
    groups = w.shape[0]
    gp = F.pad(g.float(), (0, 0, 1, 1, 1, 1))  # zero halo: [N, H+2, W+2, O]
    wf = w.to(BF16).float().repeat_interleave(n // groups, dim=0)  # [N, 3, 3, C, O]
    rows, cols = torch.arange(h), torch.arange(wd)
    rbit, cbit = frow.cpu().long(), fcol.cpu().long()
    out = torch.zeros((n, h, wd, w.shape[3]), dtype=torch.float32, device=g.device)
    for dy in range(3):
        for dx in range(3):
            wt = wf[:, dy, dx]
            rmask = ((rbit >> (dy // 2)) & 1).bool() if dy != 1 else torch.zeros(h, dtype=torch.bool)
            cmask = ((cbit >> (dx // 2)) & 1).bool() if dx != 1 else torch.zeros(wd, dtype=torch.bool)
            # halo index of g row a + 1 - dy is a + 2 - dy; the mirrored
            # tap's row a - 1 + dy is a + dy
            for ry, rm in ((rows + 2 - dy, None), (rows + dy, rmask)):
                for cx, cm in ((cols + 2 - dx, None), (cols + dx, cmask)):
                    v = gp[:, ry][:, :, cx]
                    if rm is not None:
                        v = v * rm.to(v.device)[None, :, None, None]
                    if cm is not None:
                        v = v * cm.to(v.device)[None, None, :, None]
                    out += torch.einsum("nhwo,nco->nhwc", v, wt)
    return out


def _aligned(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t`` at a 16-byte aligned address (K5/K6/K7 copy 16-byte units)."""
    if t is None or t.data_ptr() % 16 == 0:
        return t
    return t.clone()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------- plain versions

def _z_plain(x1, x2, scale, shift, x2_half_h=False) -> torch.Tensor:
    """The conv input as f32 NCHW: prologue z rounded to bf16, x2 (its
    rows lerped to full height with ``x2_half_h``) tiled."""
    n = x1.shape[0]
    z = x1.float()
    if scale is not None:
        z = torch.relu(z * per_image(scale, n) + per_image(shift, n)).to(BF16).float()
    if x2_half_h:
        x2 = lerp_h2x_plain(x2)
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


def conv3x3_fwd_plain(x1, w, *, x2=None, scale=None, shift=None,
                      x2_half_h=False):
    """Plain PyTorch version of ``conv3x3_fwd``."""
    groups, _, _ = _check(x1, w, x2, scale, shift, x2_half_h)
    z = _z_plain(x1, x2, scale, shift, x2_half_h)
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


def conv3x3_dw_plain(g, x1, groups: int, *, x2=None, scale=None, shift=None,
                     x2_half_h=False):
    """Plain PyTorch version of ``conv3x3_dw``: [G, 3, 3, C_in, O] f32."""
    n = g.shape[0]
    z = _z_plain(x1, x2, scale, shift, x2_half_h)
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


def _half_args(x2_half_h: bool, h: int, device):
    """The H-lerp tables (lo, 1 - f, f) of ``x2_half_h``, else Nones."""
    if not x2_half_h:
        return None, None, None
    return _h_tables(h // 2, device)[:3]


def conv3x3_fwd(x1: torch.Tensor, w: torch.Tensor, *,
                x2: Optional[torch.Tensor] = None,
                scale: Optional[torch.Tensor] = None,
                shift: Optional[torch.Tensor] = None,
                x2_half_h: bool = False):
    """K5.  x1 [N, H, W, C1] bf16; x2 optional [N2, H, W, C2] bf16 (image n
    reads x2 image n % N2), or [N2, H/2, W, C2] with ``x2_half_h`` (its
    rows lerped in-kernel); w [G, 3, 3, C1+C2, O] (used in bf16);
    scale/shift optional [G, C1] f32 prologue.  Returns (y [N, H, W, O]
    bf16, sum [G, O] f32, sumsq [G, O] f32).  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    groups, cin, o = _check(x1, w, x2, scale, shift, x2_half_h)
    if x1.device.type == "cpu":
        return conv3x3_fwd_plain(x1, w, x2=x2, scale=scale, shift=shift,
                                 x2_half_h=x2_half_h)
    n, h, wd, c1 = x1.shape
    plan = fwd_plan(n, h, wd, c1, cin - c1, o)
    wpk = pack_fwd_weights(w, plan)
    sc, sh = _prologue_args(scale, shift)
    _build.require_cuda(*[t for t in (x1, x2, wpk, sc, sh) if t is not None])
    _build.require_cuda(*[t for t in (x1, x2) if t is not None], dtype=BF16)
    x1, x2 = _aligned(x1), _aligned(x2)
    lo_h, fa, fb = _half_args(x2_half_h, h, x1.device)
    y = torch.empty((n, h, wd, o), device=x1.device, dtype=BF16)
    psum = torch.empty((n * plan.chunks, o), device=x1.device, dtype=torch.float32)
    psq = torch.empty_like(psum)
    _build.launch("mimo_conv3x3_fwd", x1.device, _ptr(x1), _ptr(x2), _ptr(wpk),
                  _ptr(sc), _ptr(sh), _ptr(lo_h), _ptr(fa), _ptr(fb), _ptr(y),
                  _ptr(psum), _ptr(psq), n, h, wd, c1, cin - c1,
                  0 if x2 is None else x2.shape[0], o, groups,
                  int(sc is not None), int(x2_half_h), plan.th, plan.cb,
                  plan.nb, plan.span, int(plan.im2col))
    conv3x3_fwd.launches += 1
    return y, reduce_groups(psum, groups), reduce_groups(psq, groups)


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
    n, h, wd, _ = g.shape
    plan = dx_plan(h, wd, o, cin)
    wpk = pack_dx_weights(w, plan)
    sc, sh = _prologue_args(scale, shift)
    xk = x1 if scale is not None else None
    _build.require_cuda(*[t for t in (g, wpk, xk, sc, sh) if t is not None])
    _build.require_cuda(*[t for t in (g, xk) if t is not None], dtype=BF16)
    g = _aligned(g)
    frow, fcol = fold_table(h, g.device), fold_table(wd, g.device)
    dx = torch.empty((n, h, wd, cin), device=g.device, dtype=BF16)
    pdsc = pdsh = None
    if sc is not None:
        pdsc = torch.empty((n * plan.chunks, cin), device=g.device,
                           dtype=torch.float32)
        pdsh = torch.empty_like(pdsc)
    _build.launch("mimo_conv3x3_dx", g.device, _ptr(g), _ptr(wpk),
                  _ptr(frow), _ptr(fcol), _ptr(xk), _ptr(sc), _ptr(sh), _ptr(dx), None, _ptr(pdsc),
                  _ptr(pdsh), n, h, wd, o, cin, 0, 0, groups,
                  int(sc is not None), plan.th, plan.cb, plan.span)
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
    plan = dx_plan(h, wd, o, cin)
    wpk = pack_dx_weights(w, plan)
    _build.require_cuda(g, wpk)
    _build.require_cuda(g, dtype=BF16)
    g = _aligned(g)
    frow, fcol = fold_table(h, g.device), fold_table(wd, g.device)
    dx1 = torch.empty((n, h, wd, c1), device=g.device, dtype=BF16)
    dx2 = torch.empty((n2, h, wd, cin - c1), device=g.device, dtype=BF16)
    _build.launch("mimo_conv3x3_dx", g.device, _ptr(g), _ptr(wpk),
                  _ptr(frow), _ptr(fcol), None, None, None, _ptr(dx1), _ptr(dx2), None, None, n, h, wd,
                  o, c1, cin - c1, n2, groups, 0, plan.th, plan.cb, plan.span)
    conv3x3_dx_fold.launches += 1
    return dx1, dx2


def conv3x3_dw(g: torch.Tensor, x1: torch.Tensor, groups: int, *,
               x2: Optional[torch.Tensor] = None,
               scale: Optional[torch.Tensor] = None,
               shift: Optional[torch.Tensor] = None,
               x2_half_h: bool = False) -> torch.Tensor:
    """K7.  g [N, H, W, O] bf16 cotangent of y; x1, x2, scale, shift,
    x2_half_h the forward's inputs -> dw [G, 3, 3, C1+C2, O] f32."""
    c1 = x1.shape[-1]
    cin = c1 + (0 if x2 is None else x2.shape[-1])
    o = g.shape[-1]
    _check(x1, g.new_empty((groups, 3, 3, cin, o)), x2, scale, shift, x2_half_h)
    if g.shape[:3] != x1.shape[:3]:
        raise ValueError("g and x1 differ in N, H, W")
    if g.device.type == "cpu":
        return conv3x3_dw_plain(g, x1, groups, x2=x2, scale=scale, shift=shift,
                                x2_half_h=x2_half_h)
    n, h, wd, _ = g.shape
    plan = dw_plan(n, h, wd, c1, cin - c1, o, groups)
    sc, sh = _prologue_args(scale, shift)
    _build.require_cuda(*[t for t in (g, x1, x2, sc, sh) if t is not None])
    _build.require_cuda(*[t for t in (g, x1, x2) if t is not None], dtype=BF16)
    g, x1, x2 = _aligned(g), _aligned(x1), _aligned(x2)
    lo_h, fa, fb = _half_args(x2_half_h, h, g.device)
    partial = torch.empty((groups * plan.chunks, 9 * cin * o), device=g.device,
                          dtype=torch.float32)
    _build.launch("mimo_conv3x3_dw", g.device, _ptr(x1), _ptr(x2), _ptr(g),
                  _ptr(sc), _ptr(sh), _ptr(lo_h), _ptr(fa), _ptr(fb),
                  _ptr(partial), n, h, wd, c1, cin - c1,
                  0 if x2 is None else x2.shape[0], o, groups,
                  int(sc is not None), int(x2_half_h), plan.th, plan.cb,
                  plan.nb, plan.span, int(plan.im2col))
    conv3x3_dw.launches += 1
    return reduce_groups(partial, groups).view(groups, 3, 3, cin, o)


# ---------------------------------------------------------------- autograd

class Conv3x3Train(torch.autograd.Function):
    """(y, sum, sumsq) = conv3x3_fwd(x1, w, x2=x2, scale=scale, shift=shift,
    x2_half_h=x2_half_h) with the gradient of ``_train_bwd_rule``
    (ct_train.py:1137): the statistics' cotangents fold into y's (g_eff,
    K9), then dx (K6, plain or fold form; with ``x2_half_h`` the fold's
    x2 cotangent goes to half height through K14) and dw (K7).  dw is
    returned in w's dtype (the fast path passes bf16 weights, as the JAX
    package does)."""

    @staticmethod
    def forward(ctx, x1, x2, w, scale, shift, x2_half_h=False):
        y, s, q = conv3x3_fwd(x1, w, x2=x2, scale=scale, shift=shift,
                              x2_half_h=x2_half_h)
        ctx.save_for_backward(x1, x2, w, scale, shift, y)
        ctx.x2_half_h = x2_half_h
        return y, s, q

    @staticmethod
    def backward(ctx, dy, dsum, dsumsq):
        # the fast path names the conv's site on its node (fast_path._conv_bn)
        site = getattr(ctx, "site", None)
        with span(f"mimo.train_conv_bwd.{site}") if site else contextlib.nullcontext():
            x1, x2, w, scale, shift, y = ctx.saved_tensors
            groups = w.shape[0]
            if dy is None:
                dy = torch.zeros_like(y)
            zeros = torch.zeros((groups, y.shape[-1]), device=y.device)
            geff = g_eff(dy.contiguous(), y,
                         zeros if dsum is None else dsum,
                         zeros if dsumsq is None else dsumsq)
            need_x1, need_x2, need_w, need_sc, need_sh = ctx.needs_input_grad[:5]
            dx1 = dx2 = dw = dsc = dsh = None
            if x2 is not None:
                if need_x1 or need_x2:
                    dx1, dx2 = conv3x3_dx_fold(geff, w, x1.shape[-1], x2.shape[0])
                    if ctx.x2_half_h:
                        dx2 = lerp_h2x_transpose(dx2)
            elif scale is not None:
                if need_x1 or need_sc or need_sh:
                    dx1, dsc, dsh = conv3x3_dx(geff, w, x1=x1, scale=scale,
                                               shift=shift)
                    dsc, dsh = dsc.to(scale.dtype), dsh.to(shift.dtype)
            elif need_x1:
                dx1 = conv3x3_dx(geff, w)
            if need_w:
                dw = conv3x3_dw(geff, x1, groups, x2=x2, scale=scale, shift=shift,
                                x2_half_h=ctx.x2_half_h).to(w.dtype)
            return dx1, dx2, dw, dsc, dsh, None


conv3x3_fwd.launches = 0
conv3x3_dx.launches = 0
conv3x3_dx_fold.launches = 0
conv3x3_dw.launches = 0
