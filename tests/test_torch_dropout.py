"""The port's dropout slice held against the JAX package (CPU).

The two packages' random numbers differ, so every comparison with the JAX
package replays the JAX key tree here (``jax_masks``) and injects those
masks into the port through ``DropoutSource(masks=...)``.  Shapes: fbc 6,
S=2, B=2.

* The grouped 1x1 (K11) and, at per-image parameters (groups = N), K8 and
  K12: each plain version against the Pallas kernel in interpret mode,
  forward and VJP, at the tolerances of tests/test_torch_train_kernels.py.
* One f32 ``train_step`` of the MC recipe (encoder, core and decoder
  Dropout2d at 0.1) on the plain path against the JAX task's, at
  docs/PARITY.md's 2e-4 forward / 1e-4 gradient bounds, at 32x256 as
  tests/test_torch_train.py's step (its two images are equal, so the
  input transform's permutations, which the packages draw differently,
  change nothing).
* The train kernel route (``ct_kernels="force"``) with the MC recipe
  against ``mimo_unet_apply_ct_train(interpret=True)`` at 32x256, where
  the JAX package takes its aligned route (the port's one train route),
  by the measures of tests/test_torch_train.py.
* MC-dropout eval through the kernel route against
  ``mimo_unet_apply_ct(mc_dropout=True, interpret=True)`` at 32x256 within
  3e-2 * max|ref| (the JAX package's own bound for its CT path).
* The final-dropout train route (K8, dropout, K11 forward and backward)
  against the port's plain route with one injected mask, both measured
  against the f32 plain route (the JAX CT path draws this mask on its own
  layout, fast_path.py:1369-1371, so it cannot be replayed).
* ``Ensemble`` MC: width, pass-major order, liveness; routing; mask
  statistics.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimo_unet_tpu.loss_buffer import LossBufferState as JaxLossBuffer
from mimo_unet_tpu.models.fast_path import (
    mimo_unet_apply_ct,
    mimo_unet_apply_ct_train,
)
from mimo_unet_tpu.models.mimo_unet import mimo_unet_apply
from mimo_unet_tpu.ops.pallas.ct_conv import align8
from mimo_unet_tpu.ops.pallas.ct_elem import conv1x1_ct
from mimo_unet_tpu.tasks.mimo import MimoUnetTask as JaxTask, TrainState as JaxState

from mimo_unet_torch.interop import jax_loss_buffer_to_state, jax_pytree_to_state_dict
from mimo_unet_torch.kernels import Conv1x1, launch_counts, reset_launch_counts
from mimo_unet_torch.models.ensemble import Ensemble
from mimo_unet_torch.models.fast_path import fast_path_supported, train_path_supported
from mimo_unet_torch.models.mimo_unet import MimoUNet, MimoUNetConfig, dropout_sites
from mimo_unet_torch.ops.dropout import DropoutSource, dropout, keep_scale
from mimo_unet_torch.tasks.mimo import MimoUnetTask, TrainState

from test_torch_slice import BASE, jax_weights, torch_model
from test_torch_train import (
    _cosines,
    _param_dict,
    _running_stats,
    assert_jax_aligned_route,
    refuse_plain_down1_and_up4,
)
from test_torch_train_kernels import (
    G, H, N, W, _bf16, _close, _ct, _nhwc, _np, _sums_close, _t,
    affine_relu_case, conv1x1_prelu_case,
)

MC = dict(encoder_dropout_rate=0.1, core_dropout_rate=0.1,
          decoder_dropout_rate=0.1)


def jit0(fn, *args):
    """``fn(*args)`` jitted at XLA:CPU backend optimization level 0.  At the
    default level XLA:CPU miscompiles the JAX package's train gradients
    with live dropout sites and S=2 (the encoder, vmapped over S, then
    disagrees with the eager step and with finite differences); at level 0
    the compiled step agrees with both, and compiles faster."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0})(*args)


def jax_masks(cfg, key, b, h, w):
    """The keep masks the JAX package's forward draws from ``key``
    (mimo_unet_apply's key tree), under the port's site names."""
    s = cfg.num_subnetworks
    k_enc, k_core, k_dec = jax.random.split(key, 3)
    keys = {}
    for i, k in enumerate(jax.random.split(k_enc, s)):
        keys[f"encoder.{i}.in_conv"], keys[f"encoder.{i}.down1"] = jax.random.split(k)
    kc = jax.random.split(k_core, 7)
    for j, site in enumerate(("down2", "down3", "down4", "center", "up1",
                              "up2", "up3")):
        keys[f"core.{site}"] = kc[j]
    for i, k in enumerate(jax.random.split(k_dec, s)):
        keys[f"decoder.{i}.up4"], keys[f"decoder.{i}.final"] = jax.random.split(k)
    out = {}
    for name, (shape, rate) in dropout_sites(cfg, b, h, w).items():
        draw = (shape[0], 1, 1, shape[1]) if len(shape) == 2 else shape
        m = jax.random.bernoulli(keys[name], 1.0 - rate, draw)
        out[name] = torch.from_numpy(np.array(m).reshape(shape))
    return out


# ---------------------------------------------------------------- kernels

@pytest.mark.parametrize("groups", [G, N])
def test_conv1x1_fwd_and_vjp_match_pallas(groups):
    rng = np.random.default_rng(10)
    c, oc = 6, 2
    z = _bf16(rng, (N, H, W, c))
    wo = rng.uniform(-1, 1, (groups, c, oc)).astype(np.float32) / np.sqrt(c)
    bo = rng.normal(0.0, 0.1, (groups, oc)).astype(np.float32)
    gout = _bf16(rng, (N, H, W, oc))
    oca = align8(oc)
    wop = jnp.zeros((groups, c, oca)).at[:, :, :oc].set(wo)
    bop = jnp.zeros((groups, oca, 1)).at[:, :oc, 0].set(bo)
    out_j, vjp = jax.vjp(
        lambda a, w_, b_: conv1x1_ct(a, w_, b_, c, groups, True),
        _ct(z, align8(c)).astype(jnp.bfloat16), wop, bop)
    dz_j, dwo_j, dbo_j = vjp(_ct(gout, oca).astype(jnp.bfloat16))

    tz = _t(z, grad=True)
    two, tbo = _t(wo, torch.float32, True), _t(bo, torch.float32, True)
    out = Conv1x1.apply(tz, two, tbo)
    dz, dwo, dbo = torch.autograd.grad(out, (tz, two, tbo), _t(gout))
    _close(_np(out), _nhwc(out_j, oc, N))
    _close(_np(dz), _nhwc(dz_j, c, N))
    _sums_close(_np(dwo), np.asarray(dwo_j)[:, :, :oc])
    _sums_close(_np(dbo), np.asarray(dbo_j)[:, :oc, 0])


def test_affine_relu_per_image_matches_pallas():
    affine_relu_case(N)


def test_conv1x1_prelu_per_image_matches_pallas():
    conv1x1_prelu_case(N)


# ---------------------------------------------------------------- train

def test_mc_train_step_f32_matches_jax():
    cfg, params, state = jax_weights()
    cfg = dataclasses.replace(cfg, **MC)
    hp = dict(in_channels=3, out_channels=2, num_subnetworks=2,
              filter_base_count=6, loss="laplace_nll", ct_kernels="off", **MC)
    rng = np.random.default_rng(13)
    one = lambda a: np.concatenate([a, a])  # noqa: E731  two equal images
    batch = {
        "image": one(rng.integers(0, 256, (1, 32, 256, 3), dtype=np.uint8)),
        "label": one(rng.uniform(0, 1, (1, 32, 256, 1)).astype(np.float32)),
    }
    lb = JaxLossBuffer(buffer=jnp.zeros((10, 2), jnp.float32),
                       index=jnp.asarray(0, jnp.int32))
    jtask = JaxTask(**hp)
    tx = jtask.make_optimizer(1)
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                      model_state=state, opt_state=tx.init(params),
                      loss_buffer=lb)
    # A zeroed channel can leave a BatchNorm channel of these random
    # weights nearly dead, and that leaf's f32 gradient ill-conditioned:
    # for most keys some leaf of the JAX step is 1e-3..1e-1 from the port's
    # f64 step (at key 0 the port's f32 step is within 2e-5 of it, the JAX
    # step 8e-3).  This key's step is well conditioned, so two f32
    # implementations can agree to 1e-4.
    key = jax.random.key(6)
    jnew, jlogs, _ = jit0(functools.partial(jtask.train_step, tx), jstate,
                          {k: jnp.asarray(v) for k, v in batch.items()}, key)
    mu = next(s.mu for s in jnew.opt_state if hasattr(s, "mu"))
    k_dropout = jax.random.split(jax.random.fold_in(key, 0))[1]

    task = MimoUnetTask(**hp)
    model = torch_model(dataclasses.asdict(task.model_config), params, state)
    opt, sched = task.make_optimizer(model.train(), 1)
    tstate = TrainState(step=0, model=model, optimizer=opt, scheduler=sched,
                        loss_buffer=jax_loss_buffer_to_state(lb),
                        generator=torch.Generator().manual_seed(0))
    masks = jax_masks(task.model_config, k_dropout, 2, 32, 256)
    _, logs, _ = task.train_step(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()},
        dropout=DropoutSource(masks=masks))

    for k in ("train_loss", "train_loss_0", "train_loss_1"):
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]), rtol=2e-4,
                                   atol=2e-4, err_msg=k)
    mu = _param_dict(mu, jnew.model_state, cfg)
    for k, p in model.named_parameters():
        m = opt.state[p]["exp_avg"].numpy()  # 0.1 * the step's gradient
        scale = float(np.max(np.abs(mu[k])))
        np.testing.assert_allclose(m, mu[k], atol=1e-4 * scale + 1e-12, rtol=0,
                                   err_msg=k)


def test_mc_train_kernel_route_matches_jax_kernels():
    """The measures of tests/test_torch_train.py's slice tests: logits by
    mean error against the JAX kernel path and by distance to the f32
    truth, BatchNorm state within 5e-3, gradient cosines to the f32 truth
    no worse than the JAX kernel path's up to its slack."""
    cfg16, params, state = jax_weights(compute_dtype="bfloat16")
    cfg16 = dataclasses.replace(cfg16, **MC)
    cfg32 = dataclasses.replace(cfg16, compute_dtype=None)
    shape = (2, 2, 32, 256, 3)
    assert_jax_aligned_route(shape)
    rng = np.random.default_rng(14)
    x = rng.uniform(0, 1, shape).astype(np.float32)
    y = rng.uniform(0, 1, shape[:4] + (2,)).astype(np.float32)
    key = jax.random.key(3)

    def loss(apply_fn):
        def f(p):
            out, new_state = apply_fn(p)
            return jnp.mean((out - y) ** 2), (out, new_state)
        return f

    (_, (out_ct, st_ct)), g_ct = jit0(jax.value_and_grad(
        loss(lambda p: mimo_unet_apply_ct_train(
            p, state, jnp.asarray(x), cfg16, rng=key, interpret=True)),
        has_aux=True), params)
    g32, (out32, _) = jit0(jax.grad(loss(lambda p: mimo_unet_apply(
        p, state, jnp.asarray(x), cfg32, train=True, rng=key)),
        has_aux=True), params)
    out16, _ = jit0(lambda p: mimo_unet_apply(
        p, state, jnp.asarray(x), cfg16, train=True, rng=key), params)

    reset_launch_counts()
    model = torch_model(dict(BASE, compute_dtype="bfloat16", ct_kernels="force",
                             **MC), params, state).train()
    refuse_plain_down1_and_up4(model)
    masks = jax_masks(cfg16, key, 2, 32, 256)
    out = model(torch.from_numpy(x), dropout=DropoutSource(masks=masks))
    torch.mean((out - torch.from_numpy(y)) ** 2).backward()
    assert set(launch_counts().values()) == {0}  # CPU: no kernel launches
    out = out.detach().numpy()
    want = np.asarray(out_ct)
    scale = float(np.max(np.abs(want)))
    assert float(np.mean(np.abs(out - want))) <= 1e-2 * scale
    e_ref = float(np.mean(np.abs(np.asarray(out16) - np.asarray(out32))))
    e_port = float(np.mean(np.abs(out - np.asarray(out32))))
    assert e_port < 1.3 * e_ref + 1e-4, (e_port, e_ref)
    got = _running_stats(model.state_dict())
    ref = _running_stats(jax_pytree_to_state_dict(params, st_ct,
                                                  model.config))
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=5e-3, rtol=0, err_msg=k)
    g32 = _param_dict(g32, state, cfg16)
    g_port = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
              for k, p in model.named_parameters()}
    cos_ct = _cosines(g32, _param_dict(g_ct, state, cfg16))
    cos_port = _cosines(g32, g_port)
    assert cos_port.min() > cos_ct.min() - 0.15, (cos_port.min(), cos_ct.min())
    assert cos_port.mean() > cos_ct.mean() - 0.05, (cos_port.mean(), cos_ct.mean())


def test_final_dropout_kernel_route_matches_plain_route():
    """One injected final-dropout mask: the kernel route (K8, the dropout,
    K11 forward and backward) and the plain bf16 route, each measured
    against the plain f32 route."""
    cfg, params, state = jax_weights()
    shape = (2, 2, 32, 128, 3)
    rng = np.random.default_rng(15)
    x = torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32))
    y = torch.from_numpy(rng.uniform(0, 1, shape[:4] + (2,)).astype(np.float32))
    kw = dict(BASE, final_dropout_rate=0.3)
    masks = {k: torch.from_numpy(rng.uniform(0, 1, s) > r) for k, (s, r) in
             dropout_sites(MimoUNetConfig(**kw), 2, 32, 128).items()}
    runs = {}
    for name, extra in (("f32", dict(ct_kernels="off")),
                        ("plain", dict(compute_dtype="bfloat16", ct_kernels="off")),
                        ("kernels", dict(compute_dtype="bfloat16", ct_kernels="force"))):
        model = torch_model(dict(kw, **extra), params, state).train()
        out = model(x, dropout=DropoutSource(masks=masks))
        torch.mean((out - y) ** 2).backward()
        runs[name] = (out.detach().numpy(), {k: p.grad.numpy() for k, p in
                                             model.named_parameters()
                                             if p.grad is not None})
    (o32, g32), (o16, g16), (ok, gk) = runs["f32"], runs["plain"], runs["kernels"]
    e_ref = float(np.mean(np.abs(o16 - o32)))
    e_k = float(np.mean(np.abs(ok - o32)))
    assert e_k < 1.3 * e_ref + 1e-4, (e_k, e_ref)
    assert gk.keys() == g16.keys()
    cos_ref, cos_k = _cosines(g32, g16), _cosines(g32, gk)
    assert cos_k.min() > cos_ref.min() - 0.15, (cos_k.min(), cos_ref.min())
    assert cos_k.mean() > cos_ref.mean() - 0.05, (cos_k.mean(), cos_ref.mean())
    # the site is live: another mask moves the logits
    other = {k: ~m for k, m in masks.items()}
    model = torch_model(dict(kw, compute_dtype="bfloat16", ct_kernels="force"),
                        params, state).train()
    with torch.no_grad():
        o2 = model(x, dropout=DropoutSource(masks=other)).numpy()
    assert float(np.max(np.abs(o2 - ok))) > 1e-2


# ---------------------------------------------------------------- eval

def test_mc_eval_kernel_route_matches_jax_kernels():
    cfg, params, state = jax_weights(compute_dtype="bfloat16")
    cfg = dataclasses.replace(cfg, ct_kernels="force", **MC)
    x = np.random.default_rng(16).uniform(0, 1, (2, 2, 32, 256, 3)).astype(
        np.float32)
    key = jax.random.key(7)
    want = np.asarray(jit0(lambda p, s, xx: mimo_unet_apply_ct(
        p, s, xx, cfg, rng=key, mc_dropout=True, interpret=True)[0],
        params, state, jnp.asarray(x)))
    masks = jax_masks(cfg, key, 2, 32, 256)
    got = {}
    for ct in ("force", "off"):  # the kernel route; the plain bf16 model
        model = torch_model(dict(BASE, compute_dtype="bfloat16", ct_kernels=ct,
                                 **MC), params, state)
        with torch.no_grad():
            got[ct] = model(torch.from_numpy(x), mc_dropout=True,
                            dropout=DropoutSource(masks=masks)).numpy()
    with torch.no_grad():
        deterministic = model(torch.from_numpy(x)).numpy()
    got, got_plain = got["force"], got["off"]
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(got, want, atol=3e-2 * scale, rtol=0)
    np.testing.assert_allclose(got_plain, want, atol=3e-2 * scale, rtol=0)
    assert float(np.max(np.abs(got - deterministic))) > 1e-3  # sites live


def _mc_member(ct_kernels="force"):
    task = MimoUnetTask(in_channels=3, out_channels=2, num_subnetworks=2,
                        filter_base_count=6, compute_dtype="bfloat16",
                        ct_kernels=ct_kernels, **MC)
    return task, task.build_model("cpu", torch.Generator().manual_seed(0))


def test_ensemble_mc_width_order_and_liveness():
    task, model = _mc_member()
    image = torch.rand(2, 32, 256, 3, generator=torch.Generator().manual_seed(1))
    mc = 3
    ens = Ensemble([(task, model)], return_raw_predictions=True,
                   monte_carlo_steps=mc,
                   generator=torch.Generator().manual_seed(4))
    assert ens.output_width == 2 * mc
    p1, p2 = ens(image)
    assert p1.shape == p2.shape == (2, 2 * mc, 32, 256, 1)
    # pass-major: column j*S + s is pass j of subnetwork s, the pass being
    # batch block j of one forward over the tiled batch
    x = image.unsqueeze(1).expand(2, 2, 32, 256, 3).repeat(mc, 1, 1, 1, 1)
    with torch.no_grad():
        q1, _ = task.forward(model, x, mc_dropout=True, dropout=DropoutSource(
            torch.Generator().manual_seed(4)))
    for j in range(mc):
        torch.testing.assert_close(p1[:, 2 * j:2 * j + 2], q1[2 * j:2 * j + 2],
                                   rtol=0, atol=0)
    assert float((p1[:, 0] - p1[:, 2]).abs().max()) > 1e-3  # passes differ
    ens.generator.manual_seed(5)
    assert float((ens(image)[0] - p1).abs().max()) > 1e-3  # another generator
    # no MC: one deterministic pass
    plain = Ensemble([(task, model)], return_raw_predictions=True)
    assert plain.output_width == 2 and plain.generator is None
    d1, _ = plain(image)
    with torch.no_grad():
        want, _ = task.forward(model, image.unsqueeze(1).expand(2, 2, 32, 256, 3))
    torch.testing.assert_close(d1, want, rtol=0, atol=0)


@pytest.mark.parametrize("kw,mc,want", [
    (MC, True, True),                                  # the MC recipe
    (dict(final_dropout_rate=0.1), True, True),
    (dict(center_dropout_rate=0.1), True, True),
    (dict(MC, filter_base_count=72), True, True),      # K11 takes C <= 128
    (dict(MC, filter_base_count=72), False, True),     # fused out-conv
])
def test_mc_routing(kw, mc, want):
    cfg = MimoUNetConfig(**{**BASE, "compute_dtype": "bfloat16",
                            "ct_kernels": "force", **kw})
    shape = (2, 2, 32, 256, 3)
    assert fast_path_supported(cfg, shape, torch.device("cpu"),
                               training=False, mc_dropout=mc) is want
    assert not fast_path_supported(cfg, shape, torch.device("cpu"),
                                   training=True, mc_dropout=mc)
    assert not train_path_supported(cfg, (2, 2, 32, 128, 3),
                                    torch.device("cpu"), training=True,
                                    mc_dropout=True)


def test_live_dropout_needs_a_source():
    model = MimoUNet(MimoUNetConfig(**BASE, **MC), device="cpu").eval()
    x = torch.zeros(1, 2, 32, 128, 3)
    with torch.no_grad():
        model(x)  # eval without MC: no site is live
        with pytest.raises(ValueError, match="DropoutSource"):
            model(x, mc_dropout=True)
    with pytest.raises(ValueError, match="DropoutSource"):
        model.train()(x)


def test_mask_statistics_and_scale():
    gen = torch.Generator().manual_seed(0)
    drops = DropoutSource(gen).draw({"a": ((400, 256), 0.1),
                                     "b": ((50, 8, 8, 16), 0.3)}, "cpu")
    for name, keep in (("a", 0.9), ("b", 0.7)):
        mask, k = drops[name]
        assert mask.dtype == torch.bool and k == pytest.approx(keep)
        assert abs(float(mask.float().mean()) - keep) < 0.01
    mask, keep = drops["a"]
    x = torch.randn(400, 256).to(torch.bfloat16)
    got = dropout(x, mask, keep)
    want = jnp.where(jnp.asarray(mask.numpy()),
                     jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) / keep, 0)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    sc = keep_scale([mask[:200], mask[200:]], keep)
    assert set(torch.unique(sc).tolist()) == {0.0, float(np.float32(1) / np.float32(keep))}
    assert torch.equal(sc, mask.float() / keep)
    with pytest.raises(ValueError, match="shape|must be"):
        DropoutSource(masks={"a": mask[:10]}).draw({"a": ((400, 256), 0.1)}, "cpu")
