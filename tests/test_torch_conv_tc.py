"""What the tensor-core kernels take from the host, on the CPU: the fused
eval DoubleConv's (K1/K2) launch plans and packed weights, and the eval
route's repair at BASELINE 5a's and 5b's up3 widths (the CUDA-core
kernel's shared memory formula refused them on the card); the train conv
kernels' K5 (fwd), K6 (dx) and K7 (dw) tile plans, K5's and K6's packed
weights, K6's reflect-fold tables, and K6's sum written with those tables (``dz_folds``: the zero-pad
full conv plus one term per fold, each a single g value) held against the
plain transpose (``_dz_plain``, autograd through the reflect conv) and
against the JAX package's Pallas dx kernels (``_conv_dx``,
``_conv_dx_fold_call``) in interpret mode.

Tolerances: ``dz_folds`` against ``_dz_plain`` 1e-5 of the largest value
(both f32, sums in another order); the rounded dx against the plain
version within one bf16 ulp of the value (f32 sums in another order may
round to the neighbouring bf16); against the Pallas kernels 1e-2 of the
largest value, as ``tests/test_torch_train_kernels.py`` holds the plain
versions (the TPU kernel adds the H folds in its bf16 staging buffer).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimo_unet_tpu.ops.pallas.ct_conv import align8, pack_w3x3
from mimo_unet_tpu.ops.pallas.ct_train import conv3x3_ct_train, pick_th_train

from mimo_unet_torch.kernels import conv3x3_train as CT
from mimo_unet_torch.kernels import fused_double_conv as _fdc  # noqa: F401
from mimo_unet_torch.kernels.train_elem import group_sum, per_image
from mimo_unet_torch.models.fast_path import check_eval_plans, fast_path_supported
from mimo_unet_torch.models.mimo_unet import MimoUNetConfig
from mimo_unet_torch.tasks.mimo import MimoUnetTask

BF = torch.bfloat16
FDC = sys.modules["mimo_unet_torch.kernels.fused_double_conv"]


def _bf16(rng, shape, scale=1.0):
    """Seeded bf16 values as float32 numpy (exactly representable)."""
    x = rng.normal(0.0, scale, shape).astype(np.float32)
    return torch.from_numpy(x).to(BF).float().numpy()


def _t(x, dtype=BF):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _dx_model(g, w, *, x1=None, scale=None, shift=None, c1=None, n2=None):
    """K6's outputs from ``dz_folds`` with the kernel's rounding points:
    dx rounded once; with the prologue da = dz * [x*sc + sh > 0], dx =
    bf16(da * sc) and the f32 sums of da*x and da; the fold form's x2
    cotangents rounded per image, summed in f32, rounded."""
    h, wd = g.shape[1:3]
    dz = CT.dz_folds(g, w, CT.fold_table(h), CT.fold_table(wd))
    groups = w.shape[0]
    if c1 is not None:
        dz2 = dz[..., c1:].to(BF).float()
        dx2 = dz2.reshape(-1, n2, *dz2.shape[1:]).sum(dim=0)
        return dz[..., :c1].to(BF), dx2.to(BF)
    if scale is None:
        return dz.to(BF)
    n, xv = g.shape[0], x1.float()
    sc = per_image(scale, n)
    da = torch.where(xv * sc + per_image(shift, n) > 0, dz, torch.zeros(()))
    return ((da * sc).to(BF), group_sum(da * xv, groups), group_sum(da, groups))


def _ulp_close(got, want):
    """bf16 tensors within one bf16 ulp of the larger magnitude."""
    a, b = got.float(), want.float()
    ulp = torch.maximum(a.abs(), b.abs()) * 2.0 ** -7 + 1e-30
    assert bool(((a - b).abs() <= ulp).all()), float((a - b).abs().max())


# ------------------------------------------------------------ packed weights

@pytest.mark.parametrize("c,o,groups", [(3, 21, 2), (21, 21, 2), (63, 31, 2),
                                        (120, 60, 3), (256, 256, 1)])
def test_pack_dx_weights_round_trip(c, o, groups):
    rng = np.random.default_rng(c + o)
    w = _t(_bf16(rng, (groups, 3, 3, c, o)), torch.float32)
    plan = CT.dx_plan(8, 8, o, c)
    wpk = CT.pack_dx_weights(w, plan)
    ws = wpk.shape[-1]
    assert wpk.dtype == BF and wpk.is_contiguous()
    assert tuple(wpk.shape) == (groups, plan.ncs, 9, plan.cb, ws)
    # the staged row stride: o padded to 16, an odd number of 16-byte units
    assert ws >= -(-o // 16) * 16 and ws % 8 == 0 and (ws // 8) % 2 == 1
    assert plan.cb * plan.ncs >= c and plan.cb * (plan.ncs - 1) < c
    assert torch.equal(CT.unpack_dx_weights(wpk, c, o), w.to(BF))
    # everything past the real channels and outputs is zero
    full = wpk.transpose(1, 2).reshape(groups, 9, plan.ncs * plan.cb, ws)
    assert not bool(full[:, :, c:].any()) and not bool(full[..., o:].any())


@pytest.mark.parametrize("c,o,groups", [(3, 21, 2), (7, 9, 1), (21, 21, 2), (63, 31, 2),
                                        (40, 80, 2), (120, 60, 3), (256, 256, 1)])
def test_pack_fwd_weights_round_trip(c, o, groups):
    rng = np.random.default_rng(c * 3 + o)
    w = _t(_bf16(rng, (groups, 3, 3, c, o)), torch.float32)
    plan = CT.fwd_plan(2, 8, 8, c, 0, o)
    wpk = CT.pack_fwd_weights(w, plan)
    ws = wpk.shape[-1]
    rows = plan.mp if plan.im2col else 9 * plan.ncs * plan.cb
    assert wpk.dtype == BF and wpk.is_contiguous()
    assert tuple(wpk.shape) == (groups, plan.nos, rows, ws)
    # the staged row stride: the output slice, an odd number of 16-byte units
    assert ws >= plan.nb and ws % 8 == 0 and (ws // 8) % 2 == 1
    assert torch.equal(CT.unpack_fwd_weights(wpk, plan, c, o), w.to(BF))
    # row k of a slice is tap k // (ncs*cb), channel k % (ncs*cb) (im2col:
    # tap k // c, channel k % c); everything past the real ones is zero
    full = wpk[..., :plan.nb].transpose(1, 2).reshape(groups, rows, -1)
    assert not bool(full[..., o:].any()) and not bool(wpk[..., plan.nb:].any())
    if plan.im2col:
        assert torch.equal(full[:, :9 * c, :o], w.to(BF).reshape(groups, 9 * c, o))
        assert not bool(full[:, 9 * c:].any())
    else:
        taps = full.reshape(groups, 9, plan.ncs * plan.cb, -1)
        assert torch.equal(taps[:, 4, :c, :o], w.to(BF)[:, 1, 1])
        assert not bool(taps[:, :, c:].any())


# ------------------------------------------------------------ fold tables

@pytest.mark.parametrize("size", [3, 4, 5, 32])
def test_fold_table(size):
    t = CT.fold_table(size)
    assert t.dtype == torch.int32 and tuple(t.shape) == (size,)
    want = np.zeros(size, np.int32)
    want[1] |= 1         # g at 0 reaches 1 through tap 0
    want[size - 2] |= 2  # g at size - 1 reaches size - 2 through tap 2
    assert np.array_equal(t.numpy(), want)


HW_SMALL = [(3, 3), (3, 5), (4, 4), (4, 3), (5, 5), (5, 4)]


@pytest.mark.parametrize("h,w", HW_SMALL + [(32, 128)])
def test_dz_folds_matches_the_plain_transpose(h, w):
    rng = np.random.default_rng(h * 10 + w)
    groups, per, cin, o = 2, 2, 5, 6
    g = _t(_bf16(rng, (groups * per, h, w, o)))
    wt = _t(_bf16(rng, (groups, 3, 3, cin, o), 0.3), torch.float32)
    got = CT.dz_folds(g, wt, CT.fold_table(h), CT.fold_table(w))
    want = CT._dz_plain(g, wt)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("h,w", HW_SMALL)
def test_dx_model_matches_the_plain_versions(h, w):
    """The three forms of K6 written with the fold tables, against the
    plain versions, at the sizes where rows and columns 1 and H-2 meet."""
    rng = np.random.default_rng(h * 7 + w)
    groups, per, c1, c2, o = 2, 2, 4, 3, 5
    n = groups * per
    g = _t(_bf16(rng, (n, h, w, o)))
    wt = _t(_bf16(rng, (groups, 3, 3, c1, o), 0.3), torch.float32)
    wf = _t(_bf16(rng, (groups, 3, 3, c1 + c2, o), 0.3), torch.float32)
    x1 = _t(_bf16(rng, (n, h, w, c1)))
    sc = torch.from_numpy(rng.uniform(0.5, 1.5, (groups, c1)).astype(np.float32))
    sh = torch.from_numpy(rng.normal(0.0, 0.3, (groups, c1)).astype(np.float32))
    _ulp_close(_dx_model(g, wt), CT.conv3x3_dx_plain(g, wt))
    got = _dx_model(g, wt, x1=x1, scale=sc, shift=sh)
    want = CT.conv3x3_dx_plain(g, wt, x1=x1, scale=sc, shift=sh)
    _ulp_close(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-4)
    for a, b in zip(_dx_model(g, wf, c1=c1, n2=per),
                    CT.conv3x3_dx_fold_plain(g, wf, c1, per)):
        _ulp_close(a, b)


# ------------------------------------------------------------ against Pallas

def _ct(x, rows=None):
    """[N, H, W, C] -> CT [rows >= C, N*H*W] (zero pad rows), jax f32."""
    c = x.shape[-1]
    ct = np.moveaxis(x, -1, 0).reshape(c, -1)
    if rows is not None and rows > c:
        ct = np.concatenate([ct, np.zeros((rows - c, ct.shape[1]), ct.dtype)])
    return jnp.asarray(ct)


def _nhwc(ct, c, n, h, w):
    a = np.asarray(jnp.asarray(ct)[:c].astype(jnp.float32))
    return np.moveaxis(a.reshape(c, n, h, w), 0, -1)


@pytest.mark.parametrize("case", ["plain", "prologue", "fold"])
def test_dx_model_matches_pallas(case):
    """32x128 (the TPU kernel's aligned width): the K6 sum from the fold
    tables against the Pallas dx kernels' cotangent (interpret mode)."""
    G, B, H, W = 2, 2, 32, 128
    N = G * B
    c1, c2, o = {"plain": (3, 0, 6), "prologue": (5, 0, 6), "fold": (4, 6, 5)}[case]
    prologue = case == "prologue"
    rng = np.random.default_rng(len(case) + 11)
    cin = c1 + c2
    x1 = _bf16(rng, (N, H, W, c1))
    x2 = _bf16(rng, (B, H, W, c2)) if c2 else None
    wt = _bf16(rng, (G, 3, 3, cin, o), 1.0 / np.sqrt(9 * cin))
    sc = rng.uniform(0.5, 1.5, (G, c1)).astype(np.float32) if prologue else None
    sh = rng.normal(0.0, 0.3, (G, c1)).astype(np.float32) if prologue else None
    cy = _bf16(rng, (N, H, W, o), 0.1)

    blocks = [[wt[g, :, :, :c1]] + ([wt[g, :, :, c1:]] if c2 else [])
              for g in range(G)]
    wp = jnp.stack([pack_w3x3([jnp.asarray(b) for b in bl]) for bl in blocks])
    c1a, oa = align8(c1), align8(o)
    spro = hpro = None
    if prologue:
        spro = jnp.zeros((G, c1a, 1)).at[:, :c1, 0].set(sc)
        hpro = jnp.zeros((G, c1a, 1)).at[:, :c1, 0].set(sh)
    th = pick_th_train(H, W, c1, c2, o, prologue=prologue) or 8
    x1j = _ct(x1).astype(jnp.bfloat16)
    x2j = _ct(x2).astype(jnp.bfloat16) if c2 else None

    def f(a1, a2):
        return conv3x3_ct_train(a1, a2, wp, spro, hpro, H, W, th, c1, c2, o,
                                B if c2 else 0, True)

    (y_j, s_j, q_j), vjp = jax.vjp(f, x1j, x2j)
    dx1_j, dx2_j = vjp((_ct(cy, oa).astype(jnp.bfloat16),
                        jnp.zeros_like(s_j), jnp.zeros_like(q_j)))

    g, w = _t(cy), _t(wt, torch.float32)
    if case == "fold":
        got = _dx_model(g, w, c1=c1, n2=B)
        want = (_nhwc(dx1_j, c1, N, H, W), _nhwc(dx2_j, c2, B, H, W))
    elif prologue:
        got = _dx_model(g, w, x1=_t(x1), scale=torch.from_numpy(sc),
                        shift=torch.from_numpy(sh))[:1]
        want = (_nhwc(dx1_j, c1, N, H, W),)
    else:
        got = (_dx_model(g, w),)
        want = (_nhwc(dx1_j, c1, N, H, W),)
    for a, b in zip(got, want):
        a = a.float().numpy()
        scale = float(np.max(np.abs(b))) or 1.0
        assert a.shape == b.shape
        assert float(np.max(np.abs(a - b))) <= 1e-2 * scale


# ------------------------------------------------------------ tile plans

# (n, h, w, c1, c2, o, groups): the 640x480 B=4 and 256x256 B=64 sites, fbc
# 40's widest, the x2-half decoder, the channel limit, images smaller than
# one tile
PLANS = [(8, 480, 640, 3, 0, 21, 2), (8, 480, 640, 21, 42, 31, 2),
         (8, 240, 320, 42, 0, 42, 2), (128, 256, 256, 21, 42, 31, 2),
         (6, 24, 24, 40, 80, 60, 2), (4, 5, 5, 256, 0, 256, 2),
         (4, 3, 3, 100, 156, 256, 2), (2, 4, 7, 1, 0, 1, 1)]


@pytest.mark.parametrize("shape", PLANS)
def test_tile_plans(shape):
    n, h, w, c1, c2, o, groups = shape
    cin = c1 + c2
    for plan in (CT.dw_plan(n, h, w, c1, c2, o, groups), CT.dx_plan(h, w, o, cin),
                 CT.fwd_plan(n, h, w, c1, c2, o)):
        assert plan.th in (1, 2, 4, 8) and 0 < plan.smem <= CT.SMEM_MAX
        # the tiles cover each pixel of an image exactly once
        assert plan.tiles_w == -(-w // CT.TW)
        assert plan.tpi == -(-h // plan.th) * plan.tiles_w
        cover = np.zeros((-(-h // plan.th) * plan.th, plan.tiles_w * CT.TW), int)
        for t in range(plan.tpi):
            r0, c0 = t // plan.tiles_w * plan.th, t % plan.tiles_w * CT.TW
            cover[r0:r0 + plan.th, c0:c0 + CT.TW] += 1
        assert (cover == 1).all()
    dw = CT.dw_plan(n, h, w, c1, c2, o, groups)
    tiles = n // groups * dw.tpi
    # chunks of span tiles: none empty; partial rows = groups * chunks
    assert dw.chunks == -(-tiles // dw.span) and (dw.chunks - 1) * dw.span < tiles
    assert dw.im2col == (9 * cin <= 64)
    if dw.im2col:
        assert (dw.cb, dw.ncs, dw.mp) == (16, 1, -(-9 * cin // 16) * 16) and dw.mp <= 64
    else:  # M slices of at most 4 mma tiles, covering cin
        assert dw.cb % 16 == 0 and dw.cb <= 64 and dw.cb * dw.ncs >= cin
        assert dw.cb * (dw.ncs - 1) < cin
    assert dw.nb % 8 == 0 and dw.nb <= 32 and dw.nb * dw.nos >= o > dw.nb * (dw.nos - 1)
    assert dw.smem == CT._dw_smem(dw.th, c1, c2, o, dw.cb, dw.nb, dw.im2col, dw.mp)
    dx = CT.dx_plan(h, w, o, cin)
    assert dx.cb % 8 == 0 and dx.cb <= 64 and dx.cb * dx.ncs >= cin
    assert dx.chunks == -(-dx.tpi // dx.span)  # prologue partial rows: n * chunks
    fw = CT.fwd_plan(n, h, w, c1, c2, o)
    # the staged z as K7 takes it; output slices of at most 8 n-tiles
    assert (fw.im2col, fw.cb, fw.ncs, fw.mp) == (dw.im2col, dw.cb, dw.ncs, dw.mp)
    assert fw.nb % 8 == 0 and fw.nb <= 64 and fw.nb * fw.nos >= o > fw.nb * (fw.nos - 1)
    # blocks of span tiles of one image (statistics rows: n * chunks)
    assert 1 <= fw.span <= min(CT.FWD_SPAN, fw.tpi)
    assert fw.chunks == -(-fw.tpi // fw.span) and (fw.chunks - 1) * fw.span < fw.tpi
    assert fw.smem == CT._fwd_smem(fw.th, c1, c2, fw.cb, fw.ncs, fw.nb, fw.im2col, fw.mp)
    if max(cin, o) <= 64:  # the flagship's widths: tall tiles, two blocks a multiprocessor
        assert fw.th == 8 and fw.nos == 1 and fw.smem <= CT.SMEM_TWO


def test_tile_plans_raise_past_the_channel_limit():
    with pytest.raises(ValueError, match="at most 256"):
        CT.dw_plan(2, 8, 8, 200, 57, 8, 1)
    with pytest.raises(ValueError, match="at most 256"):
        CT.dx_plan(8, 8, 257, 8)
    with pytest.raises(ValueError, match="at most 256"):
        CT.fwd_plan(2, 8, 8, 200, 57, 8)
    with pytest.raises(ValueError, match="at most 256"):
        CT.fwd_plan(2, 8, 8, 8, 0, 257)


# ------------------------------------------------------------ K1/K2 plans

# (c1, c2, m, o): the flagship's in_conv, down1, up3 and decoder; fbc 40's
# up3 and decoder; BASELINE 5a's and 5b's up3 and decoder; a 1-channel
# conv
FDC_SITES = [(3, 0, 21, 21), (21, 0, 42, 42), (84, 84, 84, 42), (21, 42, 31, 21),
             (160, 160, 160, 80), (40, 80, 60, 40), (180, 180, 180, 90),
             (30, 90, 60, 30), (240, 240, 240, 120), (30, 120, 75, 30), (1, 0, 1, 1)]


@pytest.mark.parametrize("site", FDC_SITES)
def test_fused_plans(site):
    c1, c2, m, o = site
    cin = c1 + c2
    plan = FDC.plan_of(c1, c2, m, o)
    th, tw = plan.th, plan.tw
    assert plan == next(FDC.plans(c1, c2, m, o))  # the first that fits
    assert any(plan.smem <= lim and (th, tw) == tile and plan.warps == warps
               for lim, tile, warps in FDC.PLAN_ORDER)
    assert th % 2 == 0  # row pairs for the H half-pool
    assert 0 < plan.smem <= FDC.SMEM_MAX
    assert plan.smem == FDC._smem(th, tw, c1, c2, o, plan.im2col, plan.cb, plan.ncs,
                                  plan.nb1, plan.cb2, plan.ncs2 * plan.cb2, plan.nb2)
    assert plan.im2col == (c2 == 0 and 9 * c1 <= 64)
    if plan.im2col:  # (tap, channel) folded into one K padded to 16
        assert (plan.ncs, plan.cb) == (1, -(-9 * c1 // 16) * 16)
    else:  # K slices of whole k-steps covering C_in, none empty
        assert plan.cb % 16 == 0 and plan.cb <= 64
        assert plan.cb * plan.ncs >= cin > plan.cb * (plan.ncs - 1)
    assert plan.cb2 % 16 == 0 and plan.cb2 * plan.ncs2 >= m > plan.cb2 * (plan.ncs2 - 1)
    # each conv's warp grid holds a whole tile's m-tiles, MTW a warp, and
    # its passes cover the channels, NTW n-tiles a warp
    for px, wn, nb, npass, nch in (((th + 2) * (tw + 2), plan.wn1, plan.nb1, plan.np1, m),
                                   (th * tw, plan.wn2, plan.nb2, plan.np2, o)):
        assert wn in (1, 2, 4, 8, 16) and wn <= plan.warps
        assert -(-px // 16) <= FDC.MTW * (plan.warps // wn)
        assert nb % 8 == 0 and nb <= wn * FDC.NTW * 8
        assert nb * npass >= nch > nb * (npass - 1)
    assert plan.warps == 8 or plan.smem > FDC.SMEM_TWO  # sixteen warps: one block
    if max(cin, m, o) <= 64:  # the flagship's narrow sites: two blocks a multiprocessor
        assert plan.smem <= FDC.SMEM_TWO


@pytest.mark.parametrize("site,groups", [((3, 0, 21, 21), 2), ((21, 42, 31, 21), 2),
                                         ((84, 84, 84, 42), 1), ((30, 90, 60, 30), 3),
                                         ((240, 240, 240, 120), 1)])
def test_fused_pack_weights_round_trip(site, groups):
    c1, c2, m, o = site
    cin = c1 + c2
    rng = np.random.default_rng(cin + m)
    w1 = _t(_bf16(rng, (groups, 3, 3, cin, m)), torch.float32)
    w2 = _t(_bf16(rng, (groups, 3, 3, m, o)), torch.float32)
    plan = FDC.plan_of(c1, c2, m, o)
    wpk = FDC.pack_weights(w1, w2, plan)
    rows1 = plan.cb if plan.im2col else 9 * plan.cb
    n1 = plan.np1 * plan.ncs * rows1 * plan.ws1
    assert wpk.dtype == BF and wpk.is_contiguous()
    assert tuple(wpk.shape) == (groups, n1 + plan.np2 * plan.ncs2 * 9 * plan.cb2 * plan.ws2)
    for ws in (plan.ws1, plan.ws2):  # staged rows: an odd number of 16-byte units
        assert ws % 8 == 0 and (ws // 8) % 2 == 1
    a, b = FDC.unpack_weights(wpk, plan, cin, m, o)
    assert torch.equal(a, w1.to(BF)) and torch.equal(b, w2.to(BF))
    # conv1's chunk (pass p, slice ks) is [9][cb][ws1] (im2col [cb][ws1],
    # row tap * C_in + c): row (t, c), column n holds w1[t, ks*cb + c,
    # p*nb1 + n]; conv2's chunks follow, [9][cb2][ws2]
    p, ks = plan.np1 - 1, plan.ncs - 1
    chunk = wpk[0, (p * plan.ncs + ks) * rows1 * plan.ws1:][:rows1 * plan.ws1]
    chunk = chunk.view(rows1, plan.ws1)
    wt = w1.to(BF)[0].reshape(9 * cin if plan.im2col else 9, -1 if plan.im2col else cin, m)
    if plan.im2col:
        want = wt.reshape(9 * cin, m)[:, p * plan.nb1:(p + 1) * plan.nb1]
        assert torch.equal(chunk[:9 * cin, :want.shape[1]], want)
        assert not bool(chunk[9 * cin:].any())
    else:
        c0 = ks * plan.cb
        want = wt[:, c0:c0 + plan.cb, p * plan.nb1:(p + 1) * plan.nb1]
        got = chunk.view(9, plan.cb, plan.ws1)
        assert torch.equal(got[:, :want.shape[1], :want.shape[2]], want)
        assert not bool(got[:, want.shape[1]:].any()) and not bool(got[..., want.shape[2]:].any())
    q = wpk[0, n1:n1 + 9 * plan.cb2 * plan.ws2].view(9, plan.cb2, plan.ws2)
    want = w2.to(BF)[0].reshape(9, m, o)[:, :plan.cb2, :plan.nb2]
    assert torch.equal(q[:, :want.shape[1], :want.shape[2]], want)


def _cuda_core_smem(cin, m, o):
    """The CUDA-core K1's shared memory (fused_double_conv.cu before the
    tensor-core kernel): the slab or output tile, the mid, the lerp table
    of an 8x16 tile."""
    slab, tile = cin * 12 * 20 * 2, 8 * 16 * o * 2
    return -(-max(slab, tile) // 16) * 16 + m * 10 * 18 * 2 + 4 * 2 * 12


@pytest.mark.parametrize("s,want", [(3, 237696), (4, 316896)])
def test_baseline_up3_widths_fit_the_new_plan(s, want):
    """BASELINE 5a (S=3) and 5b (S=4) at fbc 30: their up3 DoubleConv
    (2FS + 2FS -> 2FS -> FS, as the model builds it) needed more shared
    memory than a block has in the CUDA-core kernel, which refused the
    launch on the card ("invalid argument"); the tensor-core plan fits it,
    and the eval route takes the configuration."""
    task = MimoUnetTask(in_channels=3, out_channels=2, num_subnetworks=s,
                        filter_base_count=30, loss="laplace_nll", compute_dtype="bfloat16",
                        ct_kernels="force")
    model = task.build_model(torch.device("cpu"), torch.Generator().manual_seed(0))
    c1, _, _, c2, _, _ = model.core.up3.conv.double_conv
    cin, m, o = c1.in_channels, c1.out_channels, c2.out_channels
    assert (cin, m, o) == (120 * s, 60 * s, 30 * s)
    assert _cuda_core_smem(cin, m, o) == want > FDC.SMEM_MAX
    plan = FDC.plan_of(cin // 2, cin // 2, m, o)
    assert plan.smem <= FDC.SMEM_MAX
    cfg = task.model_config
    check_eval_plans(cfg)
    assert fast_path_supported(cfg, (2, s, 32, 256, 3), torch.device("cpu"), training=False)


def test_eval_route_raises_past_the_plan_limit():
    """A configuration whose up3 fits no plan (S=4, fbc 60: 960 -> 480 ->
    240) raises at routing, naming the limit, on the CPU with "force" and
    for CUDA inputs under "auto"; the plain model takes it only under
    "off"."""
    shape = (2, 4, 32, 256, 3)
    for ct, dev in (("force", "cpu"), ("auto", "cuda")):
        cfg = MimoUNetConfig(in_channels=3, out_channels=2, num_subnetworks=4,
                             filter_base_count=60, compute_dtype="bfloat16", ct_kernels=ct)
        with pytest.raises(ValueError, match="takes at most 232448 bytes"):
            fast_path_supported(cfg, shape, torch.device(dev), training=False)
    cfg = MimoUNetConfig(in_channels=3, out_channels=2, num_subnetworks=4,
                         filter_base_count=60, compute_dtype="bfloat16", ct_kernels="off")
    assert not fast_path_supported(cfg, shape, torch.device("cuda"), training=False)
