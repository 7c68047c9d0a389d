"""The port's x2-half train decoder, held against the JAX package (CPU), and
the repairs that came with it.

* K14 ``lerp_h2x_transpose_plain`` against ``lerp_h2x_transpose_ct`` and
  K4b ``upsample_w2x_bwd_plain`` against ``upsample_w2x_ct``'s VJP, both
  in interpret mode at XLA:CPU backend optimization level 0 (``jit0``:
  the default level contracts the TPU kernels' f32 arithmetic into FMAs).
  K14 is bitwise.  K4b is bitwise too here; one bf16 ulp is allowed, as
  the TPU kernel's weights are a dot whose summation order XLA chooses.
* Composition: K14 then K4b is K13's backward; ``Conv3x3Train`` with
  ``x2_half_h`` fed ``UpsampleW2x(x)`` is ``Conv3x3Train`` fed
  ``Upsample2x(x)``, bitwise in y, its statistics and every gradient
  (the port's twin of tests/test_ct_train.py:613 ``TestX2HalfH``).
* The slice with ``MIMO_CT_TRAIN_X2_HALF=1`` (``ct_kernels="force"``: on
  the CPU each wrapper runs its plain version): bitwise the default
  route, with K4, K4b and K14 run and K13 not; and against the JAX
  package's own x2-half route (``mimo_unet_apply_ct_train``, interpret),
  by tests/test_torch_train.py's measures, with the JAX side shown to
  have taken that route.
* Repairs: K1's staged H lerp is bitwise the JAX kernel's (the f32
  reciprocal weight), the channel limits raise instead of leaving the
  kernel route, and a grad-enabled eval forward keeps its gradient.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimo_unet_tpu.models.fast_path import mimo_unet_apply_ct_train
from mimo_unet_tpu.models.mimo_unet import mimo_unet_apply
from mimo_unet_tpu.ops.pallas.ct_conv import fused_double_conv_ct, pack_w3x3
from mimo_unet_tpu.ops.pallas.ct_resize import (
    lerp_h2x_transpose_ct,
    lerp_h2x_transpose_supported,
    upsample_w2x_ct,
)

from mimo_unet_torch.kernels import (
    Conv3x3Train,
    Upsample2x,
    UpsampleW2x,
    conv3x3_dw,
    conv3x3_fwd,
    conv3x3_fwd_plain,
    fused_double_conv_plain,
    launch_counts,
    lerp_h2x_transpose,
    lerp_h2x_transpose_plain,
    reset_launch_counts,
    upsample2x_bwd_plain,
    upsample_w2x_bwd,
    upsample_w2x_bwd_plain,
)
from mimo_unet_torch.models.ensemble import Ensemble
from mimo_unet_torch.models.fast_path import fast_path_supported, train_path_supported
from mimo_unet_torch.models.mimo_unet import MimoUNet, MimoUNetConfig
from mimo_unet_torch.tasks.mimo import MimoUnetTask

from test_torch_dropout import jit0
from test_torch_slice import BASE, jax_weights, torch_model
from test_torch_train import (
    SHAPE,
    _cosines,
    _param_dict,
    _running_stats,
    refuse_plain_down1_and_up4,
)
from test_torch_train_kernels import _bf16, _ct, _nhwc, _np, _t

BF16 = torch.bfloat16
FLAG = "MIMO_CT_TRAIN_X2_HALF"
upsample2x_mod = sys.modules["mimo_unet_torch.kernels.upsample2x"]
upsample_w2x_mod = sys.modules["mimo_unet_torch.kernels.upsample_w2x"]
fdc_mod = sys.modules["mimo_unet_torch.kernels.fused_double_conv"]


def _equal(got, want):
    np.testing.assert_array_equal(got, want)


def _ulp_bf16(v):
    """One bf16 ulp at |v| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(max(float(v), 2.0 ** -126))) - 7)


# ---------------------------------------------------------------- K14, K4b

def test_lerp_h2x_transpose_plain_matches_pallas_bitwise():
    c, n, h2, w = 8, 2, 8, 256
    assert lerp_h2x_transpose_supported(c, n, h2, w)
    g = _bf16(np.random.default_rng(20), (n, 2 * h2, w, c))
    want = jit0(lambda v: lerp_h2x_transpose_ct(v, n, h2, w, interpret=True),
                _ct(g).astype(jnp.bfloat16))
    want = _nhwc(want, c, n, h2, w)
    _equal(_np(lerp_h2x_transpose_plain(_t(g))), want)
    _equal(_np(lerp_h2x_transpose(_t(g))), want)  # CPU: the plain version


@pytest.mark.parametrize("c,rows,w2", [(8, 6, 128), (21, 4, 256)])
def test_upsample_w2x_bwd_plain_matches_pallas_vjp(c, rows, w2):
    """Bitwise on these inputs; the bound allows one bf16 ulp (the dot's
    f32 order is XLA's)."""
    rng = np.random.default_rng(c)
    x = _bf16(rng, (1, rows, w2, c))
    g = _bf16(rng, (1, rows, 2 * w2, c))

    def vjp(v, gg):
        return jax.vjp(lambda a: upsample_w2x_ct(a, rows, w2, True), v)[1](gg)[0]

    want = _nhwc(jit0(vjp, _ct(x).astype(jnp.bfloat16), _ct(g).astype(jnp.bfloat16)),
                 c, 1, rows, w2)
    got = _np(upsample_w2x_bwd_plain(_t(g)))
    assert np.abs(got - want).max() <= _ulp_bf16(np.abs(want).max())
    _equal(got, want)
    # the autograd function (on the CPU: the plain versions)
    tx = _t(x, grad=True)
    (dx,) = torch.autograd.grad(UpsampleW2x.apply(tx), tx, _t(g))
    _equal(_np(dx), got)
    _equal(_np(upsample_w2x_bwd(_t(g))), got)


@pytest.mark.parametrize("b", [1, 2])
def test_x2_half_composes_to_the_full_upsample(b):
    """K14 then K4b is K13's backward, and the train conv with x2_half_h
    fed the W half is the train conv fed K13's output: y, sum, sumsq and
    the gradients of x1, the half-res x and w, bitwise.  b = 1 and 2
    images of x2 (period b), so image-boundary rows are covered."""
    rng = np.random.default_rng(30 + b)
    groups, h, w, c1, c2, o = 2, 16, 24, 4, 6, 5
    n = groups * b
    g = _bf16(rng, (b, h, w, c2))
    _equal(_np(upsample_w2x_bwd_plain(lerp_h2x_transpose_plain(_t(g)))),
           _np(upsample2x_bwd_plain(_t(g))))

    x1 = _bf16(rng, (n, h, w, c1))
    xh = _bf16(rng, (b, h // 2, w // 2, c2))
    wt = _bf16(rng, (groups, 3, 3, c1 + c2, o), scale=0.2)
    gy = _bf16(rng, (n, h, w, o), scale=0.1)
    gs, gq = rng.normal(0, 0.1, (2, groups, o)).astype(np.float32)

    def run(half):
        tx1, txh = _t(x1, grad=True), _t(xh, grad=True)
        tw = _t(wt, torch.float32, grad=True)
        up = UpsampleW2x.apply(txh) if half else Upsample2x.apply(txh)
        outs = Conv3x3Train.apply(tx1, up, tw, None, None, half)
        grads = torch.autograd.grad(outs, (tx1, txh, tw),
                                    (_t(gy), torch.from_numpy(gs),
                                     torch.from_numpy(gq)))
        return [_np(t) for t in outs + grads]

    for got, want in zip(run(True), run(False)):
        _equal(got, want)


def test_train_conv_x2_half_h_shape_rules():
    x1 = torch.zeros(4, 8, 8, 3, dtype=BF16)
    w = torch.zeros(2, 3, 3, 5, 4)
    half, full = torch.zeros(2, 4, 8, 2, dtype=BF16), torch.zeros(2, 8, 8, 2, dtype=BF16)
    conv3x3_fwd_plain(x1, w, x2=half, x2_half_h=True)
    with pytest.raises(ValueError):  # a full-height x2 with the flag
        conv3x3_fwd(x1, w, x2=full, x2_half_h=True)
    with pytest.raises(ValueError):  # a half-height x2 without it
        conv3x3_fwd(x1, w, x2=half)
    with pytest.raises(ValueError):  # the flag needs x2
        conv3x3_fwd(x1, torch.zeros(2, 3, 3, 3, 4), x2_half_h=True)
    with pytest.raises(ValueError):  # the cotangents have even H (W) >= 4
        lerp_h2x_transpose(torch.zeros(2, 5, 8, 3, dtype=BF16))
    with pytest.raises(ValueError):
        upsample_w2x_bwd(torch.zeros(2, 4, 7, 3, dtype=BF16))


@pytest.mark.parametrize("which", ["lerp_h2x_transpose", "upsample_w2x_bwd",
                                   "conv3x3_fwd", "conv3x3_dw"])
def test_x2_half_wrappers_raise_off_cpu_without_cuda(which):
    """Only CPU tensors take the plain version: any other device launches
    the kernel or raises (here: meta tensors, no fallback)."""
    def meta(*shape, dtype=BF16):
        return torch.zeros(shape, dtype=dtype, device="meta")

    with pytest.raises(ValueError, match="CUDA"):
        if which == "lerp_h2x_transpose":
            lerp_h2x_transpose(meta(2, 8, 16, 3))
        elif which == "upsample_w2x_bwd":
            upsample_w2x_bwd(meta(2, 4, 16, 3))
        elif which == "conv3x3_fwd":
            conv3x3_fwd(meta(4, 8, 8, 3), meta(2, 3, 3, 5, 4, dtype=torch.float32),
                        x2=meta(2, 4, 8, 2), x2_half_h=True)
        else:
            conv3x3_dw(meta(4, 8, 8, 4), meta(4, 8, 8, 3), 2, x2=meta(2, 4, 8, 2),
                       x2_half_h=True)


# ---------------------------------------------------------------- the slice

def _spy(monkeypatch, calls):
    """Count the calls of the resample plain versions and record the
    train conv forward's and dw's x2_half_h."""
    for mod, name in ((upsample_w2x_mod, "upsample_w2x_plain"),
                      (upsample_w2x_mod, "upsample_w2x_bwd_plain"),
                      (upsample2x_mod, "lerp_h2x_transpose_plain"),
                      (upsample2x_mod, "upsample2x_plain"),
                      (upsample2x_mod, "upsample2x_bwd_plain")):
        def counted(*a, _f=getattr(mod, name), _n=name, **k):
            calls[_n] = calls.get(_n, 0) + 1
            return _f(*a, **k)
        monkeypatch.setattr(mod, name, counted)


def _port_step(params, state, x, y, flag, monkeypatch):
    """One port forward + backward on the kernel route with the decoder
    flag set or not: (logits, loss, gradients, running statistics, calls)."""
    monkeypatch.setenv(FLAG, flag)
    calls = {}
    with monkeypatch.context() as m:
        _spy(m, calls)
        model = torch_model(dict(BASE, compute_dtype="bfloat16",
                                 ct_kernels="force"), params, state).train()
        refuse_plain_down1_and_up4(model)
        out = model(torch.from_numpy(x))
        loss = torch.mean((out - torch.from_numpy(y)) ** 2)
        loss.backward()
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
             for k, p in model.named_parameters()}
    return (out.detach().numpy(), float(loss.detach()), grads,
            _running_stats(model.state_dict()), calls)


@pytest.fixture(scope="module")
def slice_inputs():
    cfg16, params, state = jax_weights(compute_dtype="bfloat16")
    rng = np.random.default_rng(11)  # tests/test_torch_train.py's slice draw
    x = rng.uniform(0, 1, SHAPE).astype(np.float32)
    y = rng.uniform(0, 1, SHAPE[:4] + (2,)).astype(np.float32)
    return cfg16, params, state, x, y


def test_x2_half_slice_is_bitwise_the_default_route(slice_inputs, monkeypatch):
    _, params, state, x, y = slice_inputs
    half = _port_step(params, state, x, y, "1", monkeypatch)
    full = _port_step(params, state, x, y, "0", monkeypatch)
    _equal(half[0], full[0])
    assert half[1] == full[1]
    for got, want in ((half[2], full[2]), (half[3], full[3])):
        assert got.keys() == want.keys()
        for k in want:
            _equal(got[k], want[k])
    # K4 forward, K4b and K14 backward ran and K13 did not; the default
    # route the reverse (K13's backward runs its H transpose inside)
    assert half[4] == {"upsample_w2x_plain": 1, "upsample_w2x_bwd_plain": 1,
                       "lerp_h2x_transpose_plain": 1}, half[4]
    assert full[4] == {"upsample2x_plain": 1, "upsample2x_bwd_plain": 1,
                       "lerp_h2x_transpose_plain": 1}, full[4]
    assert set(launch_counts().values()) == {0}  # CPU: no kernel launches


@pytest.fixture(scope="module")
def jax_half_route(slice_inputs):
    """The JAX package's x2-half route (its kernels in interpret mode) and
    its f32 XLA gradients at the slice shape.  The flag is read while
    tracing, so the function is traced afresh under it."""
    cfg16, params, state, x, y = slice_inputs
    cfg32 = dataclasses.replace(cfg16, compute_dtype=None)

    def loss(apply_fn):
        def f(p):
            out, new_state = apply_fn(p)
            return jnp.mean((out - y) ** 2), (out, new_state)
        return f

    ct = jax.value_and_grad(loss(lambda p: mimo_unet_apply_ct_train(
        p, state, jnp.asarray(x), cfg16, interpret=True)), has_aux=True)
    old = os.environ.get(FLAG)
    os.environ[FLAG] = "1"
    try:
        traced = jax.jit(ct).trace(params)
        jaxpr = str(traced.jaxpr)
        (_, (out_ct, st_ct)), g_ct = traced.lower().compile()(params)
    finally:
        if old is None:
            del os.environ[FLAG]
        else:
            os.environ[FLAG] = old
    g32, _ = jit0(jax.grad(loss(lambda p: mimo_unet_apply(
        p, state, jnp.asarray(x), cfg32, train=True)), has_aux=True), params)
    return dict(jaxpr=jaxpr, out_ct=np.asarray(out_ct),
                st_ct=_running_stats(_sd(params, st_ct, cfg16)),
                g_ct=_param_dict(g_ct, state, cfg16),
                g32=_param_dict(g32, state, cfg16))


def _sd(params, state, cfg):
    from mimo_unet_torch.interop import jax_pytree_to_state_dict

    return jax_pytree_to_state_dict(params, state, cfg)


def test_x2_half_slice_matches_the_jax_x2_half_route(slice_inputs, jax_half_route,
                                                     monkeypatch):
    """tests/test_torch_train.py's measures against the JAX package's
    x2-half route: logits by mean abs error within 1e-2 * max|ref|, BN
    state within 5e-3, bf16 gradients by cosine to the f32 XLA gradients,
    no worse than the JAX route's own up to that file's slack."""
    r = jax_half_route
    # the JAX side took the route: its backward names K4b and K14
    assert "upw2_ct_bwd_c" in r["jaxpr"] and "uph2_ct_bwd_c" in r["jaxpr"]
    _, params, state, x, y = slice_inputs
    out, _, grads, stats, calls = _port_step(params, state, x, y, "1", monkeypatch)
    assert calls.get("lerp_h2x_transpose_plain") == 1
    want = r["out_ct"]
    assert out.shape == want.shape == SHAPE[:4] + (2,)
    assert float(np.mean(np.abs(out - want))) <= 1e-2 * float(np.max(np.abs(want)))
    assert stats.keys() == r["st_ct"].keys()
    for k in stats:
        np.testing.assert_allclose(stats[k], r["st_ct"][k], atol=5e-3, rtol=0,
                                   err_msg=k)
    cos_ct = _cosines(r["g32"], r["g_ct"])
    cos_port = _cosines(r["g32"], grads)
    assert cos_port.min() > cos_ct.min() - 0.15, (cos_port.min(), cos_ct.min())
    assert cos_port.mean() > cos_ct.mean() - 0.05, (cos_port.mean(), cos_ct.mean())


# ---------------------------------------------------------------- repairs

def _discriminating_pairs(h2):
    """For each full row r of a 2*h2-row x2 upsample whose lerp weight f
    differs between the quotient float32(d) / (H-1) and the product
    float32(d) * float32(1/(H-1)): bf16 values (a, b) whose staged value
    bf16(a*(1-f) + b*f) differs between the two.  {r: (a, b)}."""
    h = 2 * h2
    num = np.arange(h) * (h2 - 1)
    lo = np.minimum(num // (h - 1), h2 - 2)
    d = (num - lo * (h - 1)).astype(np.float32)
    fq, fr = d / np.float32(h - 1), d * (np.float32(1) / np.float32(h - 1))

    def bf(v):
        return torch.from_numpy(np.asarray(v, np.float32)).to(BF16).float().numpy()

    grid = np.unique(bf(np.linspace(0.5, 4.0, 1000)))
    a, b = (t.ravel() for t in np.meshgrid(grid, grid, indexing="ij"))
    pairs = {}
    for r in np.nonzero(fq != fr)[0]:
        lq = bf(a * (np.float32(1) - fq[r]) + b * fq[r])
        lr = bf(a * (np.float32(1) - fr[r]) + b * fr[r])
        k = np.nonzero(lq != lr)[0]
        if len(k):
            pairs[int(r)] = (a[k[0]], b[k[0]])
    return lo, pairs


def test_fused_double_conv_staged_lerp_is_bitwise_the_jax_kernels():
    """K1's in-kernel H lerp (x2_half_h) at H = 64, where the quotient and
    the reciprocal weights differ at 30 rows: a DoubleConv whose only
    weights are identity centre taps from x2 channel 0 returns its staged
    rows, and on inputs chosen where the two weights round differently
    they are bitwise the JAX kernel's at jit0, which is the reciprocal
    form (ct_conv.py:224-225 as XLA compiles it)."""
    h, w, c = 64, 128, 8
    lo, pairs = _discriminating_pairs(h // 2)
    assert len(pairs) >= 20
    rng = np.random.default_rng(40)
    x1 = _bf16(rng, (1, h, w, c))
    x2 = _np(_t(rng.uniform(0.5, 2.0, (1, h // 2, w, c))))
    rows = sorted(pairs)
    for j in range(w):  # each column shows one row's rounding
        r = rows[j % len(rows)]
        x2[0, lo[r], j, 0], x2[0, lo[r] + 1, j, 0] = pairs[r]
    w1 = np.zeros((1, 3, 3, 2 * c, c), np.float32)
    w1[0, 1, 1, c, 0] = 1.0
    w2 = np.zeros((1, 3, 3, c, c), np.float32)
    w2[0, 1, 1, 0, 0] = 1.0
    one, zero = np.ones((1, c), np.float32), np.zeros((1, c), np.float32)
    w1p = jnp.stack([pack_w3x3([jnp.asarray(w1[0, :, :, :c]),
                                jnp.asarray(w1[0, :, :, c:])])])
    w2p = jnp.stack([pack_w3x3([jnp.asarray(w2[0])])])
    out = jit0(lambda a, b: fused_double_conv_ct(
        a, w1p, one, zero, w2p, one, zero, h=h, w=w, th=8, c1=c, m=c, o=c,
        x2=b, c2=c, n2_images=1, x2_half_h=True, interpret=True),
        _ct(x1).astype(jnp.bfloat16), _ct(x2).astype(jnp.bfloat16))
    want = _nhwc(out, 1, 1, h, w)[0, ..., 0]
    args = [torch.from_numpy(t) for t in (w1, one, zero, w2, one, zero)]
    got = _np(fused_double_conv_plain(_t(x1), *args, x2=_t(x2),
                                      x2_half_h=True))[0, ..., 0]
    _equal(got, want)
    # the inputs tell the two weights apart: the quotient form misses
    d = (np.arange(h) * (h // 2 - 1) - lo * (h - 1)).astype(np.float32)
    f = d / np.float32(h - 1)
    a, b = x2[0, lo, :, 0], x2[0, lo + 1, :, 0]
    quot = (a * (np.float32(1) - f[:, None]) + b * f[:, None]).astype(np.float32)
    assert np.sum(_np(_t(quot)) != want) >= 20


@pytest.mark.parametrize("kw,training", [
    (dict(num_subnetworks=4, filter_base_count=60), True),   # 60 + 240 > 256
    (dict(out_channels=10), True),                            # out-conv OC > 8
    (dict(filter_base_count=130, decoder_dropout_rate=0.1), False),  # MC, K11
])
def test_channel_limits_raise_instead_of_leaving_the_route(kw, training):
    """A configuration the kernels cannot take raises, naming the limit,
    on the CPU with "force" and for CUDA inputs under "auto"; it is never
    sent to the plain model in silence."""
    shape = (2, kw.get("num_subnetworks", 2), 32, 256, 3)
    supported = train_path_supported if training else fast_path_supported
    for ct, dev in (("force", "cpu"), ("auto", "cuda")):
        cfg = MimoUNetConfig(**{**BASE, "compute_dtype": "bfloat16",
                                "ct_kernels": ct, **kw})
        with pytest.raises(ValueError, match="take at most"):
            supported(cfg, shape, torch.device(dev), training=training,
                      mc_dropout=not training)
    cfg = dataclasses.replace(cfg, ct_kernels="off")  # plain: no limit
    assert not supported(cfg, shape, torch.device("cuda"), training=training,
                         mc_dropout=not training)


def test_eval_forward_with_grad_keeps_its_gradient(monkeypatch):
    """An eval forward that needs an input gradient (FGSM) on the kernel
    route runs the plain modules and returns the plain model's gradient;
    under no_grad, as predict runs it, the eval kernels still run."""
    calls = []
    plain_fdc = fdc_mod.fused_double_conv_plain
    monkeypatch.setattr(fdc_mod, "fused_double_conv_plain",
                        lambda *a, **k: calls.append(1) or plain_fdc(*a, **k))
    cfg, params, state = jax_weights(compute_dtype="bfloat16")
    x = np.random.default_rng(50).uniform(0, 1, SHAPE).astype(np.float32)
    grads = {}
    for ct in ("force", "off"):
        model = torch_model(dict(BASE, compute_dtype="bfloat16", ct_kernels=ct),
                            params, state)
        tx = torch.from_numpy(x).requires_grad_()
        model(tx).square().mean().backward()
        grads[ct] = tx.grad.numpy()
    assert not calls  # the eval kernels carry no gradient: not reached
    assert np.abs(grads["off"]).max() > 0
    _equal(grads["force"], grads["off"])

    task = MimoUnetTask(**BASE, loss="laplace_nll", compute_dtype="bfloat16",
                        ct_kernels="force")
    model = torch_model(dataclasses.asdict(task.model_config), params, state)
    reset_launch_counts()
    Ensemble([(task, model)]).predict(x[:, 0], batch_size=2)
    assert len(calls) == 4  # in_conv, down1, up3, decoder
    assert set(launch_counts().values()) == {0}  # CPU: no kernel launches
