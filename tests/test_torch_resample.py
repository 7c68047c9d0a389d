"""The port's 2x2 pool (K10) and x2 align-corners upsample (K13), and the
one train route they open, held against the JAX package (CPU).

* K10: ``max_pool2x2_plain`` / ``max_pool2x2_bwd_plain`` (with and
  without the skip cotangent) against ``max_pool2x2_ct`` /
  ``max_pool2x2_skip_ct`` and their VJPs in interpret mode, bitwise, on
  inputs with forced ties (ReLU zeros, repeated bf16 values), at the
  shapes of tests/test_ct_train.py's pool tests and at C = 21.
* K13: ``upsample2x_plain`` and its transpose against ``upsample2x_ct``
  and its VJP in interpret mode, compiled at XLA:CPU backend optimization
  level 0 (``jit0``): at the default level XLA:CPU contracts the TPU
  kernel's lerp ``a*(1-f) + b*f`` into an FMA, which neither the TPU
  kernel's source nor the port's kernel does.  The forward is bitwise;
  the backward within one bf16 ulp at max|ref| (its f32 sums of five
  taps, H then W, may round in another order, and a one-ulp difference
  in the bf16 H-transpose carries into a smaller output).
* Widths the TPU kernels refuse (W = 40): both plain versions against
  ``ops/pooling.max_pool_2x2`` and an f64 align-corners reference, so the
  function, not a lane gate, is what is ported.
* The route: the port's one train route at (2, 2, 32, 256), with and
  without the MC recipe, runs K10 twice and K13 once each way and down1 on
  the train conv kernels, and reaches no plain down1 or decoder module.
  Its numbers against ``mimo_unet_apply_ct_train(interpret=True)`` at
  that shape, where the JAX package takes its aligned route, are the
  slice tests of tests/test_torch_train.py and tests/test_torch_dropout.py.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimo_unet_tpu.ops.pallas.ct_elem import (
    max_pool2x2_ct,
    max_pool2x2_skip_ct,
    pool_ct_supported,
    pool_skip_ct_supported,
)
from mimo_unet_tpu.ops.pallas.ct_resize import upsample2x_ct, upsample2x_ct_supported

from mimo_unet_torch.kernels import (
    MaxPool2x2,
    MaxPool2x2Skip,
    Upsample2x,
    launch_counts,
    max_pool2x2,
    max_pool2x2_bwd,
    max_pool2x2_bwd_plain,
    max_pool2x2_plain,
    reset_launch_counts,
    upsample2x,
    upsample2x_bwd,
    upsample2x_bwd_plain,
    upsample2x_plain,
)
from mimo_unet_torch.models.fast_path import train_path_supported
from mimo_unet_torch.ops.dropout import DropoutSource
from mimo_unet_torch.ops.pooling import max_pool_2x2
from mimo_unet_torch.ops.resize import _interp_matrix

from test_torch_dropout import MC, jax_masks, jit0
from test_torch_slice import BASE, jax_weights, torch_model
from test_torch_train import (
    SHAPE as SLICE,
    _running_stats,
    assert_jax_aligned_route,
    refuse_plain_down1_and_up4,
)
from test_torch_train_kernels import _bf16, _ct, _nhwc, _np, _t

BF16 = torch.bfloat16
pool2x2_mod = sys.modules["mimo_unet_torch.kernels.pool2x2"]
upsample2x_mod = sys.modules["mimo_unet_torch.kernels.upsample2x"]
conv_mod = sys.modules["mimo_unet_torch.kernels.conv3x3_train"]


def _tied(rng, shape):
    """bf16 values with forced ties: a third rounded to halves (repeated
    values), then a ReLU (about half zeros, all-zero windows included)."""
    x = rng.normal(0.0, 1.0, shape).astype(np.float32)
    x = np.where(rng.uniform(size=shape) < 0.3, np.round(x * 2) / 2, x)
    return torch.from_numpy(np.maximum(x, 0)).to(BF16).float().numpy()


def _equal(got, want):
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- K10

@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("c,n,h,w", [(8, 4, 8, 128), (21, 3, 16, 256)])
def test_pool2x2_plain_matches_pallas_bitwise(c, n, h, w, skip):
    assert (pool_skip_ct_supported if skip else pool_ct_supported)(c, n, h, w)
    rng = np.random.default_rng(c + skip)
    x = _tied(rng, (n, h, w, c))
    g = _bf16(rng, (n, h // 2, w // 2, c))
    gs = _bf16(rng, (n, h, w, c))
    xct = _ct(x).astype(jnp.bfloat16)
    if skip:
        (y_j, _), vjp = jax.vjp(
            lambda v: max_pool2x2_skip_ct(v, n, h, w, True), xct)
        (gx_j,) = vjp((_ct(g).astype(jnp.bfloat16), _ct(gs).astype(jnp.bfloat16)))
    else:
        y_j, vjp = jax.vjp(lambda v: max_pool2x2_ct(v, n, h, w, True), xct)
        (gx_j,) = vjp(_ct(g).astype(jnp.bfloat16))
    y_j, gx_j = _nhwc(y_j, c, n, h // 2, w // 2), _nhwc(gx_j, c, n, h, w)
    assert np.mean(y_j == 0) > 0.02  # all-zero windows: every element tied

    y = max_pool2x2_plain(_t(x))
    _equal(_np(y), y_j)
    _equal(_np(max_pool2x2_bwd_plain(_t(g), _t(x), y,
                                     _t(gs) if skip else None)), gx_j)
    # the autograd functions (on the CPU: the plain versions)
    tx = _t(x, grad=True)
    if skip:
        p, ident = MaxPool2x2Skip.apply(tx)
        (gx,) = torch.autograd.grad((p, ident), tx, (_t(g), _t(gs)))
    else:
        p = MaxPool2x2.apply(tx)
        (gx,) = torch.autograd.grad(p, tx, _t(g))
    _equal(_np(p), y_j)
    _equal(_np(gx), gx_j)


def test_pool2x2_skip_without_pool_cotangent():
    """Only the identity feeds the loss: the pool's cotangent is zero."""
    rng = np.random.default_rng(3)
    x = _tied(rng, (2, 4, 6, 5))
    tx = _t(x, grad=True)
    _, ident = MaxPool2x2Skip.apply(tx)
    gs = _bf16(rng, x.shape)
    (gx,) = torch.autograd.grad(ident, tx, _t(gs))
    _equal(_np(gx), gs)


# ---------------------------------------------------------------- K13

def _ulp_bf16(v):
    """One bf16 ulp at |v| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(max(float(v), 2.0 ** -126))) - 7)


def test_upsample2x_plain_matches_pallas():
    c, n, h2, w2 = 16, 2, 16, 128
    assert upsample2x_ct_supported(c, n, h2, w2)
    rng = np.random.default_rng(5)
    x = _bf16(rng, (n, h2, w2, c))
    g = _bf16(rng, (n, 2 * h2, 2 * w2, c))

    def fwd_bwd(v, gg):
        y, vjp = jax.vjp(lambda a: upsample2x_ct(a, n, h2, w2, True), v)
        return y, vjp(gg)[0]

    y_j, dx_j = jit0(fwd_bwd, _ct(x).astype(jnp.bfloat16),
                     _ct(g).astype(jnp.bfloat16))
    y_j, dx_j = _nhwc(y_j, c, n, 2 * h2, 2 * w2), _nhwc(dx_j, c, n, h2, w2)

    y = _np(upsample2x_plain(_t(x)))
    _equal(y, y_j)
    dx = _np(upsample2x_bwd_plain(_t(g)))
    err = np.abs(dx - dx_j)
    assert err.max() <= _ulp_bf16(np.abs(dx_j).max()), err.max()
    assert np.mean(err > 0) < 0.01, np.mean(err > 0)
    # the autograd function (on the CPU: the plain versions)
    tx = _t(x, grad=True)
    out = Upsample2x.apply(tx)
    (dxa,) = torch.autograd.grad(out, tx, _t(g))
    _equal(_np(out), y)
    _equal(_np(dxa), dx)


# ---------------------------------------------------------------- widths

def test_resample_plain_versions_at_a_width_the_tpu_refuses():
    """W = 40: no lane-aligned TPU kernel takes it; the port's functions
    do.  The pool against ops/pooling.max_pool_2x2 (NCHW, the JAX
    package's every-tied-element backward), bitwise; the upsample and its
    transpose against the f64 align-corners matrices, within 1e-2 *
    max|ref| (bf16 weights, two bf16 roundings)."""
    n, h, w, c = 2, 8, 40, 6
    assert not pool_ct_supported(c, n, h, w)
    assert not upsample2x_ct_supported(8, n, h // 2, w // 2)
    rng = np.random.default_rng(7)
    x = _tied(rng, (n, h, w, c))
    g = _bf16(rng, (n, h // 2, w // 2, c))
    tx = _t(x, grad=True)
    xn = tx.permute(0, 3, 1, 2)
    ref = max_pool_2x2(xn)
    (gref,) = torch.autograd.grad(ref, tx, _t(g).permute(0, 3, 1, 2))
    y = max_pool2x2_plain(_t(x))
    _equal(_np(y), _np(ref.permute(0, 2, 3, 1)))
    _equal(_np(max_pool2x2_bwd_plain(_t(g), _t(x), y)), _np(gref))

    h2, w2 = h // 2, w // 2
    xs = _bf16(rng, (n, h2, w2, c))
    gu = _bf16(rng, (n, h, w, c))
    mh = _interp_matrix(h2, h).astype(np.float64)
    mw = _interp_matrix(w2, w).astype(np.float64)
    want = np.einsum("oh,pw,nhwc->nopc", mh, mw, xs.astype(np.float64))
    got = _np(upsample2x_plain(_t(xs)))
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
    want_t = np.einsum("oh,pw,nopc->nhwc", mh, mw, gu.astype(np.float64))
    got_t = _np(upsample2x_bwd_plain(_t(gu)))
    assert np.abs(got_t - want_t).max() <= 1e-2 * np.abs(want_t).max()


def test_resample_wrappers_reject_bad_shapes():
    odd = torch.zeros(2, 5, 8, 3, dtype=BF16)
    with pytest.raises(ValueError):
        max_pool2x2(odd)
    x = torch.zeros(2, 4, 8, 3, dtype=BF16)
    with pytest.raises(ValueError):  # g must be the pooled shape
        max_pool2x2_bwd(torch.zeros(2, 2, 2, 3, dtype=BF16), x,
                        torch.zeros(2, 2, 4, 3, dtype=BF16))
    with pytest.raises(ValueError):  # at least two input rows
        upsample2x(torch.zeros(2, 1, 8, 3, dtype=BF16))
    with pytest.raises(ValueError):  # the cotangent has even H, W
        upsample2x_bwd(torch.zeros(2, 6, 7, 3, dtype=BF16))


@pytest.mark.parametrize("which", ["max_pool2x2", "max_pool2x2_bwd",
                                   "upsample2x", "upsample2x_bwd"])
def test_resample_wrappers_raise_off_cpu_without_cuda(which):
    """Only CPU tensors take the plain version: any other device launches
    the kernel or raises (here: meta tensors, no fallback)."""
    def meta(*shape):
        return torch.zeros(shape, dtype=BF16, device="meta")

    with pytest.raises(ValueError, match="CUDA"):
        if which == "max_pool2x2":
            max_pool2x2(meta(2, 4, 8, 3))
        elif which == "max_pool2x2_bwd":
            max_pool2x2_bwd(meta(2, 2, 4, 3), meta(2, 4, 8, 3), meta(2, 2, 4, 3),
                            meta(2, 4, 8, 3))
        elif which == "upsample2x":
            upsample2x(meta(2, 4, 8, 3))
        else:
            upsample2x_bwd(meta(2, 8, 16, 3))


# ---------------------------------------------------------------- the route

@pytest.mark.parametrize("rates", [{}, MC], ids=["plain", "mc_recipe"])
def test_train_route_runs_k10_k13_and_down1_kernels(monkeypatch, rates):
    """The port's one train route at (2, 2, 32, 256), fbc 6, with and
    without the MC recipe (the JAX package's masks): per forward and
    backward, K10 twice each way (in_conv -> down1 and down1 -> core,
    both with the skip cotangent), K13 once each way, down1's two convs on
    the train conv kernels with BatchNorm over the half-resolution pixels,
    and no plain down1 or decoder Up module.  On the CPU the wrappers run
    their plain versions, which are counted here.  (The route's numbers
    against ``mimo_unet_apply_ct_train`` at this shape are
    tests/test_torch_train.py's and tests/test_torch_dropout.py's slice
    tests.)"""
    calls = {}
    for mod, names in ((pool2x2_mod, ("max_pool2x2_plain", "max_pool2x2_bwd_plain")),
                       (upsample2x_mod, ("upsample2x_plain", "upsample2x_bwd_plain")),
                       (conv_mod, ("conv3x3_fwd_plain",))):
        for name in names:
            def counted(*a, _f=getattr(mod, name), _n=name, **k):
                calls.setdefault(_n, []).append((a, k))
                return _f(*a, **k)
            monkeypatch.setattr(mod, name, counted)

    b, s, h, w, _ = SLICE
    assert_jax_aligned_route(SLICE)
    cfg, params, state = jax_weights(compute_dtype="bfloat16")
    cfg = dataclasses.replace(cfg, **rates)
    model = torch_model(dict(BASE, compute_dtype="bfloat16", ct_kernels="force",
                             **rates), params, state).train()
    assert train_path_supported(model.config, SLICE, torch.device("cpu"),
                                training=True)
    refuse_plain_down1_and_up4(model)
    before = {k: v.copy() for k, v in _running_stats(model.state_dict()).items()}
    source = (DropoutSource(masks=jax_masks(cfg, jax.random.key(3), b, h, w))
              if rates else None)
    x = np.random.default_rng(22).uniform(0, 1, SLICE).astype(np.float32)
    reset_launch_counts()
    model(torch.from_numpy(x), dropout=source).square().mean().backward()
    assert set(launch_counts().values()) == {0}  # CPU: no kernel launches

    n, f = s * b, BASE["filter_base_count"]
    pools = [a[0].shape for a, _ in calls["max_pool2x2_plain"]]
    assert pools == [(n, h, w, f), (n, h // 2, w // 2, 2 * f)]
    skips = [a[3] is not None for a, _ in calls["max_pool2x2_bwd_plain"]]
    assert skips == [True, True]  # the core boundary's first, then down1's input
    ups = [a[0].shape for a, _ in calls["upsample2x_plain"]]
    assert ups == [(b, h // 2, w // 2, f * s)]
    assert [a[0].shape for a, _ in calls["upsample2x_bwd_plain"]] == [(b, h, w, f * s)]
    half = [a[0].shape for a, _ in calls["conv3x3_fwd_plain"]
            if a[0].shape[1:3] == (h // 2, w // 2)]
    assert half == [(n, h // 2, w // 2, f), (n, h // 2, w // 2, 2 * f)]
    # down1's BatchNorms ran on the kernel route's statistics
    after = _running_stats(model.state_dict())
    for k in before:
        if ".down1s." in k:
            assert np.abs(after[k] - before[k]).max() > 1e-3, k
