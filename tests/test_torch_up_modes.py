"""The port's transpose and unpool decoders held against the JAX package
(CPU).

Weights: the pytree structure of ``mimo_unet_init`` (by
``jax.eval_shape``) filled with seeded numpy values, BatchNorm statistics
and affine included (``test_torch_slice.jax_weights``; running the init
itself costs 10-15 s of XLA compiles a configuration), transplanted with
``jax_pytree_to_state_dict``.  fbc 4, 32x32, S=2 and S=1, torch on one
thread.  Tolerances are docs/PARITY.md's: forward 2e-4, gradients 1e-4 of
a leaf's scale at f32 and B=1 (after the kink check of
tests/test_torch_evidential.py: no ReLU input and no 2x2 pool window
within rounding of its kink), bf16 by cosine against f32.

* Ops: the index pool (values bitwise, indices through
  ``local_to_torch_flat_indices``, ties constructed), its gradient (ties
  split equally, as the gradient of ``jnp.max``), ``max_unpool_2x2`` and
  its gradient bitwise, ``conv_transpose2d`` and its init,
  ``drop_block_2d`` on the JAX centers bitwise and the three properties
  of tests/test_aux.py ``TestDropBlock``.
* Blocks: both ``Up`` modes against ``up_apply``, eval and train.
* Model: both modes at S=2 and S=1 against ``mimo_unet_apply``: eval, a
  train step's loss, gradients and running statistics, the bf16 forward,
  MC dropout with the JAX masks injected, the remat rungs bitwise "none",
  the transplant round trip with the reference's key names.
* Routing: ``ct_kernels="force"`` takes no kernel route for either mode,
  and no kernel launches.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimo_unet_tpu.interop import torch_state_dict_to_pytree
from mimo_unet_tpu.models.blocks import up_apply, up_init
from mimo_unet_tpu.models.mimo_unet import (
    MimoUNetConfig as JaxConfig,
    mimo_unet_apply,
    mimo_unet_init,
)
from mimo_unet_tpu.ops import conv as jax_conv
from mimo_unet_tpu.ops import pooling as jax_pooling
from mimo_unet_tpu.ops.regularization import drop_block_2d as jax_drop_block_2d

import mimo_unet_torch.ops.pooling as pooling
from mimo_unet_torch.interop import _up, jax_pytree_to_state_dict
from mimo_unet_torch.kernels import launch_counts, reset_launch_counts
from mimo_unet_torch.models.blocks import Up, init_conv_
from mimo_unet_torch.models.fast_path import fast_path_supported, train_path_supported
from mimo_unet_torch.models.mimo_unet import MimoUNet, MimoUNetConfig
from mimo_unet_torch.ops import (
    conv_transpose2d,
    drop_block_2d,
    local_to_torch_flat_indices,
    max_pool_2x2_with_indices,
    max_unpool_2x2,
)
from mimo_unet_torch.ops.dropout import DropoutSource
from mimo_unet_torch.ops.regularization import (
    drop_block_apply,
    drop_block_gamma,
    drop_block_keep,
)

from test_torch_dropout import jax_masks
from test_torch_slice import _leaf_values

MODES = {"transpose": dict(bilinear=False),
         "unpool": dict(bilinear=False, use_pooling_indices=True)}
BASE = dict(in_channels=3, out_channels=2, filter_base_count=4)
HW = 32


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small shapes: torch's intra-op threads cost more than they give,
    most of all beside other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def nhwc(t):
    return jnp.asarray(np.moveaxis(t.detach().numpy(), 1, -1))


@functools.lru_cache(maxsize=None)
def mode_weights(mode, s, seed=0, **rates):
    """(jax cfg, port cfg kwargs, params, state) of a ``mode`` model of
    ``s`` subnetworks, seeded values in ``mimo_unet_init``'s structure."""
    kw = dict(BASE, num_subnetworks=s, **MODES[mode], **rates)
    cfg = JaxConfig(**kw)
    shapes = jax.eval_shape(lambda k: mimo_unet_init(k, cfg), jax.random.key(seed))
    rng = np.random.default_rng(seed)
    params, state = jax.tree_util.tree_map_with_path(
        lambda path, sd: jnp.asarray(_leaf_values(path, sd.shape, rng), sd.dtype),
        shapes)
    return cfg, kw, params, state


def port_model(kw, params, state, **over):
    cfg = MimoUNetConfig(**dict(kw, **over))
    model = MimoUNet(cfg, device="cpu")
    model.load_state_dict(jax_pytree_to_state_dict(params, state, cfg))
    return model.eval()


def _image(b, s, seed=1, w=HW):
    return np.random.default_rng(seed).uniform(0, 1, (b, s, HW, w, 3)).astype(np.float32)


# ------------------------------------------------------------------- ops

def _tied(shape, seed):
    """Values on a coarse grid: many 2x2 windows hold tied maxima."""
    return (np.random.default_rng(seed).integers(0, 3, shape) * 0.5).astype(np.float32)


@pytest.mark.parametrize("hw", [(8, 8), (9, 11)])
def test_index_pool_matches_jax(hw):
    x = _tied((2, 3, *hw), 0)
    y, idx = max_pool_2x2_with_indices(torch.from_numpy(x))
    y_j, idx_j = jax_pooling.max_pool_2x2_with_indices(jnp.asarray(np.moveaxis(x, 1, -1)))
    np.testing.assert_array_equal(y.numpy(), np.moveaxis(np.asarray(y_j), -1, 1))
    want = jax_pooling.local_to_torch_flat_indices(idx_j, hw[1])
    got = local_to_torch_flat_indices(idx, hw[1])
    np.testing.assert_array_equal(got.numpy(), np.moveaxis(np.asarray(want), -1, 1))
    # the codes pick the first maximum, as torch's own pool does
    ties = (torch.from_numpy(x)[:, :, :hw[0] // 2 * 2, :hw[1] // 2 * 2]
            .unfold(2, 2, 2).unfold(3, 2, 2).reshape(*y.shape, 4) == y[..., None]).sum(-1)
    assert int((ties > 1).sum()) > 10
    np.testing.assert_array_equal(
        got.numpy(), torch.nn.functional.max_pool2d(torch.from_numpy(x), 2,
                                                    return_indices=True)[1].numpy())


@pytest.mark.parametrize("hw", [(8, 8), (9, 11)])
def test_index_pool_gradient_splits_ties_as_jax(hw):
    x = _tied((2, 3, *hw), 1)
    g = np.random.default_rng(2).normal(size=(2, 3, hw[0] // 2, hw[1] // 2)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, _ = max_pool_2x2_with_indices(xt)
    (gx,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    _, vjp = jax.vjp(lambda a: jax_pooling.max_pool_2x2_with_indices(a)[0],
                     jnp.asarray(np.moveaxis(x, 1, -1)))
    (want,) = vjp(jnp.asarray(np.moveaxis(g, 1, -1)))
    np.testing.assert_array_equal(gx.numpy(), np.moveaxis(np.asarray(want), -1, 1))
    # an all-equal window: a quarter of the cotangent to each element
    ones = torch.ones(1, 1, 2, 2, requires_grad=True)
    (g1,) = torch.autograd.grad(max_pool_2x2_with_indices(ones)[0].sum(), ones)
    np.testing.assert_array_equal(g1.numpy(), np.full((1, 1, 2, 2), 0.25, np.float32))


@pytest.mark.parametrize("out", [(8, 10), (9, 11)])
def test_unpool_and_its_gradient_bitwise_jax(out):
    src = _tied((2, 3, 8, 10), 3)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 3, 4, 5)).astype(np.float32)
    g = rng.normal(size=(2, 3, *out)).astype(np.float32)
    _, idx = max_pool_2x2_with_indices(torch.from_numpy(src))
    _, idx_j = jax_pooling.max_pool_2x2_with_indices(jnp.asarray(np.moveaxis(src, 1, -1)))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = max_unpool_2x2(xt, idx, *out)
    (gx,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    y_j, vjp = jax.vjp(lambda a: jax_pooling.max_unpool_2x2(a, idx_j, *out),
                       jnp.asarray(np.moveaxis(x, 1, -1)))
    (gx_j,) = vjp(jnp.asarray(np.moveaxis(g, 1, -1)))
    np.testing.assert_array_equal(y.detach().numpy(), np.moveaxis(np.asarray(y_j), -1, 1))
    np.testing.assert_array_equal(gx.numpy(), np.moveaxis(np.asarray(gx_j), -1, 1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_transpose2d_matches_jax(dtype):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 6, 5, 7)).astype(np.float32)
    p = jax_conv.conv_transpose2d_init(jax.random.key(0), 6, 3, 2)
    cdt = jnp.bfloat16 if dtype == "bfloat16" else None
    want = jax_conv.conv_transpose2d(jnp.asarray(np.moveaxis(x, 1, -1)).astype(cdt or jnp.float32),
                                     p, stride=2, compute_dtype=cdt)
    w = torch.from_numpy(np.transpose(np.asarray(p["w"]), (2, 3, 0, 1)).copy())
    got = conv_transpose2d(torch.from_numpy(x).to(getattr(torch, dtype)), w,
                           torch.from_numpy(np.array(p["b"])))
    want = np.moveaxis(np.asarray(want.astype(jnp.float32)), -1, 1)
    assert tuple(got.shape) == (2, 3, 10, 14) and got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)
    else:  # the same rounding points: within one bf16 rounding of the sum
        np.testing.assert_allclose(got.float().numpy(), want, atol=0,
                                   rtol=2 ** -7)


def test_conv_transpose_init_draws_the_jax_distribution():
    """U(-b, b), b = 1/sqrt(out * k * k), for weight and bias, in both."""
    cin, cout = 64, 16
    bound = 1.0 / np.sqrt(cout * 4)
    conv = torch.nn.ConvTranspose2d(cin, cout, 2, stride=2)
    init_conv_(conv, torch.Generator().manual_seed(0))
    p = jax_conv.conv_transpose2d_init(jax.random.key(0), cin, cout, 2)
    for got, want in ((conv.weight, p["w"]), (conv.bias, p["b"])):
        for a in (got.detach().numpy(), np.asarray(want)):
            assert np.abs(a).max() <= bound and np.abs(a).max() > 0.9 * bound
            assert abs(float(a.std()) - bound / np.sqrt(3)) < 0.1 * bound


@pytest.mark.parametrize("block_size", [3, 4, 5])
def test_drop_block_on_jax_centers_bitwise(block_size):
    """The JAX op's centers (its bernoulli draw, replayed) through the
    port's mask and rescale: bitwise the JAX output."""
    x = np.random.default_rng(6).normal(size=(2, 13, 12, 3)).astype(np.float32)
    rate, key = 0.3, jax.random.key(7)
    want = jax_drop_block_2d(jnp.asarray(x), rate, block_size, key, deterministic=False)
    b, h, w, c = x.shape
    gamma = drop_block_gamma(rate, block_size, h, w)
    centers = jax.random.bernoulli(key, gamma, (b, h - block_size + 1,
                                                w - block_size + 1, c))
    keep = drop_block_keep(nchw(centers.astype(jnp.float32)), block_size)
    got = drop_block_apply(nchw(x), keep)
    assert 0 < float((keep == 0).float().mean()) < 1
    np.testing.assert_array_equal(got.numpy(), np.moveaxis(np.asarray(want), -1, 1))


def test_drop_block_deterministic_identity():
    x = torch.randn(2, 4, 16, 16, generator=torch.Generator().manual_seed(0))
    assert torch.equal(drop_block_2d(x, 0.3, 5, None, deterministic=True), x)


def test_drop_block_drops_contiguous_blocks():
    x = torch.ones(8, 4, 32, 32)
    y = drop_block_2d(x, 0.2, 5, torch.Generator().manual_seed(0),
                      deterministic=False).numpy()
    dropped = y == 0
    assert 0.05 < dropped.mean() < 0.5
    assert y[y > 0].min() > 1.0  # survivors rescaled above 1
    d = dropped[0, 0]
    assert d.any()
    ys, xs = np.nonzero(d)
    i = len(ys) // 2
    yy, xx = ys[i], xs[i]
    assert d[max(yy - 2, 0):yy + 3, max(xx - 2, 0):xx + 3].sum() >= 2


def test_drop_block_zero_rate_noop():
    x = torch.ones(1, 1, 8, 8)
    y = drop_block_2d(x, 0.0, 3, torch.Generator().manual_seed(0), deterministic=False)
    assert torch.equal(y, x)


# ----------------------------------------------------------------- blocks

def _bn_state_random(tree, rng):
    """BatchNorm leaves of an up_init pytree replaced by seeded values."""
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (jnp.asarray(_leaf_values(path, a.shape, rng), a.dtype)
                         if path[-1].key in ("scale", "bias", "mean", "var") else a),
        tree)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("mode", list(MODES))
def test_up_block_matches_jax(mode, train):
    """Core-style (x1 carries in_channels, or in // 2 unpooled) and a skip
    of odd size, so pad_to_match pads."""
    cin, cout = 16, 8
    rng = np.random.default_rng(8)
    params, state = up_init(jax.random.key(1), cin, cout, mode)
    params, state = _bn_state_random((params, state), rng)
    x2 = rng.normal(size=(2, cin // 2, 9, 9)).astype(np.float32)
    if mode == "transpose":
        x1_t, idx, idx_j = torch.from_numpy(rng.normal(size=(2, cin, 4, 4)).astype(np.float32)), None, None
        x1_j = nhwc(x1_t)
    else:
        src = rng.normal(size=(2, cin // 2, 8, 8)).astype(np.float32)
        x1_t, idx = max_pool_2x2_with_indices(torch.from_numpy(src))
        x1_j, idx_j = jax_pooling.max_pool_2x2_with_indices(jnp.asarray(np.moveaxis(src, 1, -1)))
    want, new_state = up_apply(params, state, x1_j, jnp.asarray(np.moveaxis(x2, 1, -1)),
                               idx_j, mode=mode, train=train)
    sd = {}
    _up(sd, "x", params, state, mode)
    up = Up(cin, cout, mode)
    up.load_state_dict({k[2:]: v for k, v in sd.items()})
    up.train(train)
    with torch.no_grad():
        got = up(x1_t, torch.from_numpy(x2), indices=idx)
    np.testing.assert_allclose(got.numpy(), np.moveaxis(np.asarray(want), -1, 1),
                               atol=2e-4, rtol=0)
    sd_new = {}
    _up(sd_new, "x", params, new_state, mode)
    for k, v in up.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), sd_new["x." + k].numpy(), atol=2e-4,
                                       rtol=0, err_msg=k)


# ------------------------------------------------------------------ model

@pytest.mark.parametrize("s", [2, 1])
@pytest.mark.parametrize("mode", list(MODES))
def test_model_eval_matches_jax(mode, s):
    cfg, kw, params, state = mode_weights(mode, s)
    x = _image(2, s)
    want, _ = jax.jit(lambda p, st, a: mimo_unet_apply(p, st, a, cfg, train=False))(
        params, state, jnp.asarray(x))
    with torch.no_grad():
        got = port_model(kw, params, state)(torch.from_numpy(x))
    assert tuple(got.shape) == (2, s, HW, HW, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)


def _kinks(model, x):
    """(ReLU inputs within 1e-6 of their layer's largest |value| of 0, 2x2
    pool windows whose two largest values are within 1e-5 relative) in the
    port's f32 train-mode forward of ``x`` (tests/test_torch_evidential.py
    ``_kinks``, with the index pool's windows)."""
    import torch.nn.functional as F

    relu, pool, windows = torch.relu, F.max_pool2d, pooling._windows
    found = [0, 0]

    def near_zero(y):
        a = y.detach().abs()
        found[0] += int((a < 1e-6 * a.max()).sum())
        return relu(y)

    def count_ties(w):
        top = w.detach().topk(2, dim=-1).values
        rel = (top[..., 0] - top[..., 1]) / top[..., 0].abs().clamp_min(1e-30)
        found[1] += int(((rel < 1e-5) & (top[..., 0] > 0)).sum())

    def near_tie_pool(t, k):
        count_ties(windows(t))
        return pool(t, k)

    def near_tie_windows(t):
        w = windows(t)
        count_ties(w)
        return w

    torch.relu, F.max_pool2d, pooling._windows = near_zero, near_tie_pool, near_tie_windows
    try:
        with torch.no_grad():
            model(x)
    finally:
        torch.relu, F.max_pool2d, pooling._windows = relu, pool, windows
    return tuple(found)


# per case, an image seed whose forward passes the kink check: at 32x256
# about one ReLU input in 10^6 lies within 1e-6 of its layer's scale of 0,
# and most seeds have one or two
@pytest.mark.parametrize("mode,s,seed", [("transpose", 2, 2), ("transpose", 1, 4),
                                         ("unpool", 2, 12), ("unpool", 1, 4)])
def test_model_train_step_matches_jax(mode, s, seed):
    """Train mode, B=1: loss (mean square against a target), every
    parameter's gradient within 1e-4 of the leaf's scale (biases that
    train-mode BatchNorm cancels: zero in both) and the running
    statistics within 2e-4.  At 32x256, as tests/test_torch_train.py's
    step: at 32x32 the core's BatchNorms normalize 4 values an image and
    the f32 gradient is too ill-conditioned for two implementations to
    agree to 1e-4.  The transpose's ``up.bias`` feeds a conv that
    train-mode BatchNorm follows, so it cancels as the conv biases do: its
    gradient is rounding noise in both, held below 1e-6 of the largest."""
    cfg, kw, params, state = mode_weights(mode, s)
    x = _image(1, s, seed=seed, w=256)
    target = np.random.default_rng(3).normal(size=(1, s, HW, 256, 2)).astype(np.float32)

    def loss(p, st):
        y, new_st = mimo_unet_apply(p, st, jnp.asarray(x), cfg, train=True)
        return jnp.mean(jnp.square(y - jnp.asarray(target))), new_st

    (l_j, st_j), g_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(params, state)

    model = port_model(kw, params, state).train()
    assert _kinks(port_model(kw, params, state).train(), torch.from_numpy(x)) == (0, 0)
    out = model(torch.from_numpy(x))
    l_t = torch.mean(torch.square(out - torch.from_numpy(target)))
    l_t.backward()
    np.testing.assert_allclose(l_t.item(), float(l_j), rtol=2e-4, atol=0)
    want = jax_pytree_to_state_dict(g_j, st_j, MimoUNetConfig(**kw))
    names = dict(model.named_parameters())
    top = max(float(want[k].abs().max()) for k in names)
    for k, p in names.items():
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        if k.endswith("up.bias"):
            assert max(np.abs(g).max(), float(want[k].abs().max())) < 1e-6 * top, k
            continue
        scale = float(np.abs(want[k].numpy()).max())
        np.testing.assert_allclose(g, want[k].numpy(), atol=1e-4 * scale + 1e-12, rtol=0,
                                   err_msg=k)
    got_sd = model.state_dict()
    for k, v in want.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got_sd[k].numpy(), v.numpy(), atol=2e-4, rtol=0,
                                       err_msg=k)


@pytest.mark.parametrize("mode", list(MODES))
def test_model_bf16_forward_tracks_f32(mode):
    """The bf16 forward (plain modules; f32 master weights) against the
    f32 JAX forward by cosine, as the JAX package's own bf16 path."""
    cfg, kw, params, state = mode_weights(mode, 2)
    x = _image(2, 2, seed=4)
    want, _ = jax.jit(lambda p, st, a: mimo_unet_apply(p, st, a, cfg, train=False))(
        params, state, jnp.asarray(x))
    want = np.asarray(want).ravel()
    with torch.no_grad():
        got = port_model(kw, params, state, compute_dtype="bfloat16")(
            torch.from_numpy(x)).numpy().ravel()
    cos = float(got @ want / (np.linalg.norm(got) * np.linalg.norm(want)))
    assert cos > 0.999, cos
    assert np.abs(got - want).max() < 3e-2 * np.abs(want).max()


@pytest.mark.parametrize("mode,rates", [
    ("transpose", dict(encoder_dropout_rate=0.2, core_dropout_rate=0.2,
                       decoder_dropout_rate=0.2)),
    ("unpool", dict(center_dropout_rate=0.3, final_dropout_rate=0.2)),
])
def test_mc_dropout_with_jax_masks(mode, rates):
    """MC dropout at eval (BatchNorm in eval mode): the JAX key tree's
    masks injected into the port give the JAX forward."""
    cfg, kw, params, state = mode_weights(mode, 2, **rates)
    x = _image(2, 2, seed=5)
    key = jax.random.key(11)
    want, _ = jax.jit(lambda p, st, a: mimo_unet_apply(p, st, a, cfg, train=False, rng=key,
                                                       mc_dropout=True))(
        params, state, jnp.asarray(x))
    model = port_model(kw, params, state)
    masks = jax_masks(model.config, key, 2, HW, HW)
    with torch.no_grad():
        got = model(torch.from_numpy(x), mc_dropout=True,
                    dropout=DropoutSource(masks=masks))
        plain = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)
    assert np.abs(got.numpy() - plain.numpy()).max() > 1e-3  # the masks are live


@pytest.mark.parametrize("mode", list(MODES))
def test_remat_rungs_are_bitwise_none(mode):
    """One train forward + backward per rung from the same weights: loss,
    gradients and running statistics bitwise "none"'s (the indices of the
    unpool mode leave the encoder and reach the decoder)."""
    _, kw, params, state = mode_weights(mode, 2, encoder_dropout_rate=0.2,
                                        decoder_dropout_rate=0.2)
    x = torch.from_numpy(_image(2, 2, seed=6))
    masks = jax_masks(MimoUNetConfig(**kw), jax.random.key(3), 2, HW, HW)
    runs = {}
    for remat in ("none", "enc", "all"):
        model = port_model(kw, params, state, remat=remat).train()
        loss = model(x, dropout=DropoutSource(masks=masks)).square().mean()
        loss.backward()
        runs[remat] = (loss.detach(), {k: p.grad for k, p in model.named_parameters()
                                       if p.grad is not None},
                       {k: v for k, v in model.state_dict().items()
                        if k.endswith(("running_mean", "running_var",
                                       "num_batches_tracked"))})
    loss0, g0, st0 = runs["none"]
    for remat in ("enc", "all"):
        loss, g, st = runs[remat]
        assert torch.equal(loss, loss0) and g.keys() == g0.keys()
        for k in g0:
            assert torch.equal(g[k], g0[k]), (remat, k)
        for k in st0:
            assert torch.equal(st[k], st0[k]), (remat, k)


@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("mode", list(MODES))
def test_transplant_round_trip_exact(mode, s):
    """torch_state_dict_to_pytree(jax_pytree_to_state_dict(p, s)) == (p, s),
    through a strict load of the port's module, under the reference's key
    names (``core.up1.up.weight`` in the transpose mode only)."""
    cfg, kw, params, state = mode_weights(mode, s, seed=s)
    sd = jax_pytree_to_state_dict(params, state, MimoUNetConfig(**kw))
    MimoUNet(MimoUNetConfig(**kw), device="cpu").load_state_dict(sd)
    assert ("core.up1.up.weight" in sd) == (mode == "transpose")
    assert ("decoder.up4s.0.up.weight" in sd) == (mode == "transpose")
    p2, s2 = torch_state_dict_to_pytree({k: v.numpy() for k, v in sd.items()}, cfg)
    for a, b in ((params, p2), (state, s2)):
        la, ta = jax.tree.flatten(a)
        lb, tb = jax.tree.flatten(b)
        assert ta == tb
        for x, y in zip(la, lb):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# ---------------------------------------------------------------- routing

@pytest.mark.parametrize("mode", list(MODES))
def test_no_kernel_route_for_up_modes(mode):
    """``ct_kernels="force"`` in bf16 at a shape the kernels take: neither
    kernel route applies (the JAX gates, fast_path.py:153 and :888,
    refuse these modes too), the forward runs the plain modules, and no
    kernel wrapper counts a launch, in eval and in train."""
    kw = dict(BASE, num_subnetworks=2, **MODES[mode], compute_dtype="bfloat16",
              ct_kernels="force", encoder_dropout_rate=0.1)
    cfg = MimoUNetConfig(**kw)
    shape = (2, 2, HW, HW, 3)
    cpu = torch.device("cpu")
    assert not fast_path_supported(cfg, shape, cpu, training=False)
    assert not fast_path_supported(cfg, shape, cpu, training=False, mc_dropout=True)
    assert not train_path_supported(cfg, shape, cpu, training=True)
    bilinear = dataclasses.replace(cfg, bilinear=True, use_pooling_indices=False)
    assert fast_path_supported(bilinear, shape, cpu, training=False)
    model = MimoUNet(cfg, device="cpu", generator=torch.Generator().manual_seed(0)).eval()
    x = torch.rand(shape, generator=torch.Generator().manual_seed(1))
    source = DropoutSource(generator=torch.Generator().manual_seed(2))
    reset_launch_counts()
    with torch.no_grad():
        y = model(x)
        model(x, mc_dropout=True, dropout=source)
    model.train()
    model(x, dropout=source).float().mean().backward()
    assert y.shape == (2, 2, HW, HW, 2) and bool(torch.isfinite(y).all())
    assert not any(launch_counts().values()), launch_counts()


def test_both_modes_at_once_raise():
    with pytest.raises(ValueError, match="use_pooling_indices and bilinear"):
        MimoUNetConfig(**BASE, num_subnetworks=1, use_pooling_indices=True)
