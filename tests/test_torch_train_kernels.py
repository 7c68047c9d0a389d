"""The port's train kernels' plain versions held against the JAX package's
Pallas train kernels (interpret mode, CPU), forward and VJP.

On the CPU every wrapper runs its plain version, so the autograd functions
``Conv3x3Train``, ``AffineRelu`` and ``Conv1x1Prelu`` compose exactly what
their CUDA kernels compute (``chip_smoke.py`` holds the kernels to these
versions on the card).  Layout bridge: the port's channels-last
[N, H, W, C] is the TPU kernels' CT layout [C, N*H*W] after a transpose;
the port's per-group HWIO weights [G, 3, 3, C, O] are ``pack_w3x3``'s
blocks.  Tolerances: max abs <= 1e-2 * max|ref| for bf16 tensors and for
dw (which the JAX package rounds to bf16), rtol 1e-5 / atol 1e-3 for the
f32 sums (tests/test_ct_train.py:164-169).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimo_unet_tpu.ops.pallas.ct_conv import align8, pack_w3x3
from mimo_unet_tpu.ops.pallas.ct_elem import (
    affine_relu_ct,
    conv1x1_prelu_ct,
    g_eff_ct,
)
from mimo_unet_tpu.ops.pallas.ct_train import conv3x3_ct_train, pick_th_train

from mimo_unet_torch.kernels import (
    AffineRelu,
    Conv1x1Prelu,
    Conv3x3Train,
    affine_relu,
    conv1x1_prelu_bwd,
    conv3x3_dw,
    conv3x3_dx,
    conv3x3_dx_fold,
    conv3x3_fwd,
    g_eff,
)

G, B, H, W = 2, 2, 16, 128  # groups, images per group, the TPU kernels' w
N = G * B


def _bf16(rng, shape, scale=1.0):
    """Seeded bf16 values as float32 numpy (exactly representable)."""
    x = rng.normal(0.0, scale, shape).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _ct(x, rows=None):
    """[N, H, W, C] -> CT [rows >= C, N*H*W] (zero pad rows), jax f32."""
    c = x.shape[-1]
    ct = np.moveaxis(x, -1, 0).reshape(c, -1)
    if rows is not None and rows > c:
        ct = np.concatenate([ct, np.zeros((rows - c, ct.shape[1]), ct.dtype)])
    return jnp.asarray(ct)


def _nhwc(ct, c, n, h=H, w=W):
    """CT [>=c, n*h*w] -> [n, h, w, c] float32 numpy (real channels)."""
    a = np.asarray(jnp.asarray(ct)[:c].astype(jnp.float32))
    return np.moveaxis(a.reshape(c, n, h, w), 0, -1)


def _t(x, dtype=torch.bfloat16, grad=False):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype).requires_grad_(grad)


def _np(t):
    return t.detach().float().numpy()


def _close(got, want):
    scale = float(np.max(np.abs(want))) or 1.0
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    assert err <= 1e-2 * scale, (err, scale)


def _sums_close(got, want, slack=0.0):
    """rtol 1e-5 / atol 1e-3, plus ``slack``: what the summands themselves
    may differ by."""
    err = np.abs(got - want)
    bound = 1e-3 + slack + 1e-5 * np.abs(want)
    assert got.shape == want.shape and np.all(err <= bound), (err, bound)


def _stats_close(s, q, y, s_j, q_j, y_j):
    """The BatchNorm sums are of the bf16 outputs, and an output may round
    one ulp apart where the two kernels add their f32 partial products in
    another order: the sums may differ by what the outputs differ by."""
    yp, yj = y.reshape(G, -1, y.shape[-1]), y_j.reshape(G, -1, y.shape[-1])
    _sums_close(s, s_j, np.abs(yp - yj).sum(axis=1))
    _sums_close(q, q_j, np.abs(yp * yp - yj * yj).sum(axis=1))


def _unpack_dw(dwp, cs, o):
    """Packed [3*cp, 3*oa] (pack_w3x3 layout, blocks in concat order) ->
    HWIO [3, 3, sum(cs), o]."""
    cas = [align8(c) for c in cs]
    cp, oa = sum(cas), align8(o)
    dwp = np.asarray(jnp.asarray(dwp).astype(jnp.float32))
    out = np.zeros((3, 3, sum(cs), o), np.float32)
    for dy in range(3):
        for dx in range(3):
            base, at = 0, 0
            for c, ca in zip(cs, cas):
                out[dy, dx, at:at + c] = dwp[dy * cp + base:dy * cp + base + c,
                                             dx * oa:dx * oa + o]
                base += ca
                at += c
    return out


# (c1, c2, o, prologue): in_conv conv1 (no prologue), the conv2s (bn1's
# affine as prologue), decoder conv1 (x2 shared by the groups: fold dx)
CASES = {"plain": (3, 0, 6, False), "prologue": (5, 0, 6, True),
         "x2_fold": (4, 6, 5, False)}


@pytest.mark.parametrize("case", list(CASES))
def test_conv3x3_train_fwd_and_vjp_match_pallas(case):
    c1, c2, o, prologue = CASES[case]
    rng = np.random.default_rng(len(case))
    cin = c1 + c2
    x1 = _bf16(rng, (N, H, W, c1))
    x2 = _bf16(rng, (B, H, W, c2)) if c2 else None
    wt = _bf16(rng, (G, 3, 3, cin, o), 1.0 / np.sqrt(9 * cin))
    sc = rng.uniform(0.5, 1.5, (G, c1)).astype(np.float32) if prologue else None
    sh = rng.normal(0.0, 0.3, (G, c1)).astype(np.float32) if prologue else None
    cy = _bf16(rng, (N, H, W, o), 0.1)
    cs = rng.normal(0.0, 0.1, (G, o)).astype(np.float32)
    cq = rng.normal(0.0, 0.01, (G, o)).astype(np.float32)

    # ---- the JAX package's kernels (interpret mode)
    c1a, oa = align8(c1), align8(o)
    blocks = [[wt[g, :, :, :c1]] + ([wt[g, :, :, c1:]] if c2 else [])
              for g in range(G)]
    wp = jnp.stack([pack_w3x3([jnp.asarray(b) for b in bl]) for bl in blocks])
    spro = hpro = None
    if prologue:
        spro = jnp.zeros((G, c1a, 1)).at[:, :c1, 0].set(sc)
        hpro = jnp.zeros((G, c1a, 1)).at[:, :c1, 0].set(sh)
    th = pick_th_train(H, W, c1, c2, o, prologue=prologue) or 8
    args = [_ct(x1).astype(jnp.bfloat16),
            _ct(x2).astype(jnp.bfloat16) if c2 else None, wp, spro, hpro]
    diff = [i for i, a in enumerate(args) if a is not None]

    def f(*live):
        full = list(args)
        for i, a in zip(diff, live):
            full[i] = a
        return conv3x3_ct_train(*full, H, W, th, c1, c2, o, B if c2 else 0,
                                True)

    (y_j, s_j, q_j), vjp = jax.vjp(f, *[args[i] for i in diff])
    grads_j = dict(zip(diff, vjp((_ct(cy, oa).astype(jnp.bfloat16),
                                  jnp.asarray(cs), jnp.asarray(cq)))))

    # ---- the port (CPU: plain versions through the autograd function)
    tx1 = _t(x1, grad=True)
    tx2 = _t(x2, grad=True) if c2 else None
    tw = _t(wt, grad=True)  # bf16 weights: dw rounds to bf16 as in JAX
    tsc = _t(sc, torch.float32, grad=True) if prologue else None
    tsh = _t(sh, torch.float32, grad=True) if prologue else None
    y, s, q = Conv3x3Train.apply(tx1, tx2, tw, tsc, tsh)
    live = [t for t in (tx1, tx2, tw, tsc, tsh) if t is not None]
    gt = torch.autograd.grad(
        (y, s, q), live, (_t(cy), torch.from_numpy(cs), torch.from_numpy(cq)))
    gt = dict(zip(diff, gt))

    _close(_np(y), _nhwc(y_j, o, N))
    _stats_close(_np(s), _np(q), _np(y), np.asarray(s_j), np.asarray(q_j),
                 _nhwc(y_j, o, N))
    _close(_np(gt[0]), _nhwc(grads_j[0], c1, N))
    if c2:
        _close(_np(gt[1]), _nhwc(grads_j[1], c2, B))
    for g in range(G):
        _close(_np(gt[2][g]),
               _unpack_dw(grads_j[2][g], [c1] + ([c2] if c2 else []), o))
    if prologue:
        # The TPU kernel adds g's H reflect folds (rows 0 and H-1 onto rows
        # 1 and H-2) in its bf16 staging buffer (ct_train.py:466-482), the
        # port in f32: dz differs at bf16 rounding on those rows, and the
        # signed sums dscale and dshift differ by up to ~1e-3 of the sum of
        # their terms' magnitudes (da from JAX's dx = da * scale).
        da = np.abs(_nhwc(grads_j[0], c1, N) / np.repeat(sc, B, 0)[:, None, None])
        for got, want, terms in ((gt[3], grads_j[3], da * np.abs(x1)),
                                 (gt[4], grads_j[4], da)):
            _sums_close(_np(got), np.asarray(want)[:, :c1, 0],
                        1e-3 * terms.reshape(G, -1, c1).sum(axis=1))


def test_g_eff_matches_pallas():
    rng = np.random.default_rng(7)
    o = 6
    dy, y = _bf16(rng, (N, H, W, o)), _bf16(rng, (N, H, W, o))
    ds = rng.normal(0.0, 0.1, (G, o)).astype(np.float32)
    dq = rng.normal(0.0, 0.01, (G, o)).astype(np.float32)
    oa = align8(o)
    want = g_eff_ct(_ct(dy, oa).astype(jnp.bfloat16),
                    _ct(y, oa).astype(jnp.bfloat16), jnp.asarray(ds),
                    jnp.asarray(dq), o, G, True)
    got = g_eff(_t(dy), _t(y), torch.from_numpy(ds), torch.from_numpy(dq))
    # one rounding of the same f32 expression: bitwise
    np.testing.assert_array_equal(_np(got), _nhwc(want, o, N))


def affine_relu_case(groups):
    """K8's plain version against the Pallas kernel, forward and VJP, with
    [groups, C] parameters (per group or, at groups = N, per image)."""
    rng = np.random.default_rng(8)
    c = 6
    y = _bf16(rng, (N, H, W, c))
    sc = rng.uniform(0.5, 1.5, (groups, c)).astype(np.float32)
    sh = rng.normal(0.0, 0.3, (groups, c)).astype(np.float32)
    dz = _bf16(rng, (N, H, W, c))
    ca = align8(c)
    z_j, vjp = jax.vjp(lambda a, s_, h_: affine_relu_ct(a, s_, h_, c, groups, True),
                       _ct(y, ca).astype(jnp.bfloat16),
                       jnp.asarray(sc)[..., None], jnp.asarray(sh)[..., None])
    dy_j, dsc_j, dsh_j = vjp(_ct(dz, ca).astype(jnp.bfloat16))

    ty = _t(y, grad=True)
    tsc, tsh = _t(sc, torch.float32, True), _t(sh, torch.float32, True)
    z = AffineRelu.apply(ty, tsc, tsh)
    dy, dsc, dsh = torch.autograd.grad(z, (ty, tsc, tsh), _t(dz))
    np.testing.assert_array_equal(_np(z), _nhwc(z_j, c, N))
    _close(_np(dy), _nhwc(dy_j, c, N))
    _sums_close(_np(dsc), np.asarray(dsc_j)[..., 0])
    _sums_close(_np(dsh), np.asarray(dsh_j)[..., 0])


def test_affine_relu_fwd_and_vjp_match_pallas():
    affine_relu_case(G)


def conv1x1_prelu_case(groups):
    """K12's plain version against the Pallas kernel, forward and VJP, with
    [groups, ...] parameters (per group or, at groups = N, per image)."""
    rng = np.random.default_rng(9)
    c, oc = 6, 2
    y = _bf16(rng, (N, H, W, c))
    sc = rng.uniform(0.5, 1.5, (groups, c)).astype(np.float32)
    sh = rng.normal(0.0, 0.3, (groups, c)).astype(np.float32)
    wo = rng.uniform(-1, 1, (groups, c, oc)).astype(np.float32) / np.sqrt(c)
    bo = rng.normal(0.0, 0.1, (groups, oc)).astype(np.float32)
    gout = _bf16(rng, (N, H, W, oc))
    ca, oca = align8(c), align8(oc)
    wop = jnp.zeros((groups, c, oca)).at[:, :, :oc].set(wo)
    bop = jnp.zeros((groups, oca, 1)).at[:, :oc, 0].set(bo)
    out_j, vjp = jax.vjp(
        lambda a, s_, h_, w_, b_: conv1x1_prelu_ct(a, s_, h_, w_, b_, c, groups,
                                                   True),
        _ct(y, ca).astype(jnp.bfloat16), jnp.asarray(sc)[..., None],
        jnp.asarray(sh)[..., None], wop, bop)
    dy_j, dsc_j, dsh_j, dwo_j, dbo_j = vjp(_ct(gout, oca).astype(jnp.bfloat16))

    ty = _t(y, grad=True)
    tsc, tsh = _t(sc, torch.float32, True), _t(sh, torch.float32, True)
    two, tbo = _t(wo, torch.float32, True), _t(bo, torch.float32, True)
    out = Conv1x1Prelu.apply(ty, tsc, tsh, two, tbo)
    dy, dsc, dsh, dwo, dbo = torch.autograd.grad(
        out, (ty, tsc, tsh, two, tbo), _t(gout))
    _close(_np(out), _nhwc(out_j, oc, N))
    _close(_np(dy), _nhwc(dy_j, c, N))
    _sums_close(_np(dsc), np.asarray(dsc_j)[:, :c, 0])
    _sums_close(_np(dsh), np.asarray(dsh_j)[:, :c, 0])
    _sums_close(_np(dwo), np.asarray(dwo_j)[:, :, :oc])
    _sums_close(_np(dbo), np.asarray(dbo_j)[:, :oc, 0])


def test_conv1x1_prelu_fwd_and_vjp_match_pallas():
    conv1x1_prelu_case(G)


def test_train_wrappers_reject_bad_shapes():
    x = torch.zeros(4, 16, 128, 3, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # weights' C_in must match
        conv3x3_fwd(x, torch.zeros(2, 3, 3, 4, 6))
    with pytest.raises(ValueError):  # N must divide into the groups
        conv3x3_fwd(x, torch.zeros(3, 3, 3, 3, 6))
    with pytest.raises(ValueError):  # the prologue takes a single input
        conv3x3_fwd(x, torch.zeros(2, 3, 3, 5, 6), x2=torch.zeros(2, 16, 128, 2),
                    scale=torch.ones(2, 3), shift=torch.zeros(2, 3))
    with pytest.raises(ValueError):  # fold dx needs N == G * N2
        conv3x3_dx_fold(torch.zeros(4, 16, 128, 6, dtype=torch.bfloat16),
                        torch.zeros(2, 3, 3, 5, 6), 3, 3)
    with pytest.raises(ValueError):  # parameters must be [G, C]
        affine_relu(x, torch.ones(2, 4), torch.zeros(2, 4))


def _meta(*shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("which", ["conv3x3_fwd", "conv3x3_dx", "conv3x3_dw",
                                   "g_eff", "conv1x1_prelu_bwd"])
def test_train_wrappers_raise_off_cpu_without_cuda(which):
    """Only CPU tensors take the plain version: any other device launches
    the kernel or raises (here: meta tensors, no fallback)."""
    f32 = torch.float32
    with pytest.raises(ValueError, match="CUDA"):
        if which == "conv3x3_fwd":
            conv3x3_fwd(_meta(4, 16, 128, 3), _meta(2, 3, 3, 3, 6, dtype=f32))
        elif which == "conv3x3_dx":
            conv3x3_dx(_meta(4, 16, 128, 6), _meta(2, 3, 3, 3, 6, dtype=f32))
        elif which == "conv3x3_dw":
            conv3x3_dw(_meta(4, 16, 128, 6), _meta(4, 16, 128, 3), 2)
        elif which == "g_eff":
            g_eff(_meta(4, 16, 128, 6), _meta(4, 16, 128, 6),
                  _meta(2, 6, dtype=f32), _meta(2, 6, dtype=f32))
        else:
            conv1x1_prelu_bwd(_meta(4, 16, 128, 2), _meta(4, 16, 128, 6),
                              _meta(2, 6, dtype=f32), _meta(2, 6, dtype=f32),
                              _meta(2, 6, 2, dtype=f32))
