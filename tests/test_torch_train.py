"""The port's train slice held against the JAX package (CPU).

* The train kernel path (``ct_kernels="force"``: on the CPU every kernel
  wrapper runs its plain version) against ``mimo_unet_apply_ct_train`` with
  the Pallas kernels in interpret mode, at (B, S, H, W) = (2, 2, 32, 256),
  fbc 6: there the JAX package takes its aligned route (K10 pools at the
  in_conv -> down1 and down1 -> core boundaries, down1 on the train conv
  kernels, the K13 upsample), the counterpart of the port's one train
  route; at 32x128 it would take the route of 640x480 frames (down1 as
  the plain Down block), which the port no longer has.  Logits by mean abs error
  (see the test), BatchNorm state within 5e-3; bf16 gradients held by
  cosine against the f32 XLA gradients (ROADMAP C), no worse than the JAX
  package's own kernel path up to the slack test_ct_train.py:240-241 uses.
* One whole f32 ``train_step`` on the plain path against
  ``MimoUnetTask.train_step`` (``ct_kernels="off"``): loss, logs and the
  step's outputs (``with_outputs``), Adam's
  first moments (0.1 * gradient), parameters, BatchNorm state and the
  loss-buffer ring, to docs/PARITY.md's 2e-4 forward / 1e-4 gradient
  bounds.  B=1, so the input transform's permutations are the identity in
  both packages (their random draws differ), at 32x256: at 32x128 these
  random weights make the gradient chaotic (a 1e-5 relative change of the
  input moves a bottleneck leaf's gradient by 17 % in either package), so
  two f32 implementations cannot agree to 1e-4 there.
* Routing, the input transform, the loss buffer, the schedule, and the
  entry points' device default.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimo_unet_tpu.loss_buffer import (
    LossBufferState as JaxLossBuffer,
    loss_buffer_add as jax_lb_add,
    loss_buffer_weights as jax_lb_weights,
)
from mimo_unet_tpu.models.fast_path import (
    _ct_train_down1_aligned,
    mimo_unet_apply_ct_train,
)
from mimo_unet_tpu.models.mimo_unet import mimo_unet_apply
from mimo_unet_tpu.ops.pallas.ct_elem import pool_skip_ct_supported
from mimo_unet_tpu.ops.pallas.ct_resize import upsample2x_ct_supported
from mimo_unet_tpu.tasks.mimo import MimoUnetTask as JaxTask, TrainState as JaxState
from mimo_unet_tpu.train.optim import step_lr_schedule

from mimo_unet_torch.interop import jax_loss_buffer_to_state, jax_pytree_to_state_dict
from mimo_unet_torch.kernels import launch_counts, reset_launch_counts
from mimo_unet_torch.loss_buffer import (
    loss_buffer_add,
    loss_buffer_init,
    loss_buffer_weights,
)
from mimo_unet_torch.models.fast_path import train_path_supported
from mimo_unet_torch.models.mimo_unet import MimoUNet, MimoUNetConfig
from mimo_unet_torch.tasks.mimo import MimoUnetTask, TrainState
from mimo_unet_torch.train.optim import step_lr_factor
from mimo_unet_torch.transforms import apply_input_transform

from test_torch_slice import BASE, jax_weights, torch_model

SHAPE = (2, 2, 32, 256, 3)  # B, S, H, W, C: the JAX package's aligned route
TASK = dict(in_channels=3, out_channels=2, num_subnetworks=2,
            filter_base_count=6, loss="laplace_nll")


def _param_dict(tree, state, cfg):
    """A JAX params-shaped pytree (gradients, Adam moments) under the
    port's parameter names (the transplant is linear: transposes only)."""
    sd = jax_pytree_to_state_dict(tree, state, cfg)
    return {k: v.numpy() for k, v in sd.items()
            if not k.endswith(("running_mean", "running_var",
                               "num_batches_tracked"))}


def _running_stats(sd):
    return {k: np.asarray(v) for k, v in sd.items()
            if k.endswith(("running_mean", "running_var"))}


def _cosines(ref, other):
    """Per-leaf cosine of ``other`` to ``ref``, leaves of noise-level
    magnitude skipped (test_ct_train.py:225-234)."""
    out = []
    for k, a in ref.items():
        if float(np.max(np.abs(a))) < 5e-3:
            continue
        b = other[k]
        out.append(float(np.sum(a * b) / (np.linalg.norm(a) * np.linalg.norm(b)
                                           + 1e-12)))
    return np.array(out)


def assert_jax_aligned_route(shape):
    """The JAX package's train kernel path takes its aligned route at
    ``shape`` for fbc 6, S=2: K10 at both pools, K13 in the decoder."""
    b, s, h, w, _ = shape
    assert _ct_train_down1_aligned(h, w)
    assert pool_skip_ct_supported(8, s * b, h, w)             # align8(fbc)
    assert pool_skip_ct_supported(16, s * b, h // 2, w // 2)  # align8(2 fbc)
    assert upsample2x_ct_supported(16, b, h // 2, w // 2)     # align8(c_up)


def refuse_plain_down1_and_up4(model):
    """Make the encoder's plain down1 and the decoder's plain Up modules
    raise if called: the train route runs kernels there."""
    def refuse(*_, **__):
        raise AssertionError("the train route reached a plain module")

    for mod in list(model.encoder.down1s) + list(model.decoder.up4s):
        mod.forward = refuse


@pytest.fixture(scope="module")
def slice_run():
    """One forward + backward of the JAX kernel path (interpret), the JAX
    f32 XLA path, and the port's kernel path, on the same weights."""
    assert_jax_aligned_route(SHAPE)
    cfg16, params, state = jax_weights(compute_dtype="bfloat16")
    cfg32 = dataclasses.replace(cfg16, compute_dtype=None)
    rng = np.random.default_rng(11)
    x = rng.uniform(0, 1, SHAPE).astype(np.float32)
    y = rng.uniform(0, 1, SHAPE[:4] + (2,)).astype(np.float32)

    def loss(apply_fn):
        def f(p):
            out, new_state = apply_fn(p)
            return jnp.mean((out - y) ** 2), (out, new_state)
        return f

    # jit: the interpret-mode kernels run eagerly five times slower
    (_, (out_ct, st_ct)), g_ct = jax.jit(jax.value_and_grad(
        loss(lambda p: mimo_unet_apply_ct_train(
            p, state, jnp.asarray(x), cfg16, interpret=True)),
        has_aux=True))(params)
    g32, (out32, _) = jax.jit(jax.grad(loss(lambda p: mimo_unet_apply(
        p, state, jnp.asarray(x), cfg32, train=True)), has_aux=True))(params)
    out16, _ = jax.jit(lambda p: mimo_unet_apply(
        p, state, jnp.asarray(x), cfg16, train=True))(params)

    reset_launch_counts()
    model = torch_model(dict(BASE, compute_dtype="bfloat16",
                             ct_kernels="force"), params, state).train()
    refuse_plain_down1_and_up4(model)
    out = model(torch.from_numpy(x))
    torch.mean((out - torch.from_numpy(y)) ** 2).backward()
    assert set(launch_counts().values()) == {0}  # CPU: no kernel launches
    g_port = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
              for k, p in model.named_parameters()}
    return dict(out32=np.asarray(out32), out16=np.asarray(out16),
                out_ct=np.asarray(out_ct),
                st_ct=jax_pytree_to_state_dict(params, st_ct, cfg16),
                g_ct=_param_dict(g_ct, state, cfg16),
                g32=_param_dict(g32, state, cfg16), out=out.detach().numpy(),
                st_port=model.state_dict(), g_port=g_port)


def test_train_slice_forward_and_bn_state_match_jax_kernels(slice_run):
    """Logits: the mean abs error against the JAX kernel path within
    1e-2 * max|ref|, and no farther from the f32 truth than the JAX
    package's own bf16 XLA path, as test_ct_train.py:201-203 holds its
    kernel path.  Not the max abs error: through nine train-mode
    BatchNorms a one-ulp bf16 difference grows, and the JAX package's two
    bf16 paths differ by up to 14 % of max|ref| at this shape (the port's
    kernel path and the JAX one by 3 %)."""
    r = slice_run
    want = r["out_ct"]
    assert r["out"].shape == want.shape == SHAPE[:4] + (2,)
    scale = float(np.max(np.abs(want)))
    assert float(np.mean(np.abs(r["out"] - want))) <= 1e-2 * scale
    e_ref = float(np.mean(np.abs(r["out16"] - r["out32"])))
    e_port = float(np.mean(np.abs(r["out"] - r["out32"])))
    assert e_port < 1.3 * e_ref + 1e-4, (e_port, e_ref)
    got, ref = _running_stats(r["st_port"]), _running_stats(r["st_ct"])
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=5e-3, rtol=0, err_msg=k)


def test_train_slice_gradients_track_f32_truth(slice_run):
    r = slice_run
    assert r["g_port"].keys() == r["g32"].keys()
    cos_ct = _cosines(r["g32"], r["g_ct"])
    cos_port = _cosines(r["g32"], r["g_port"])
    assert cos_port.min() > cos_ct.min() - 0.15, (cos_port.min(), cos_ct.min())
    assert cos_port.mean() > cos_ct.mean() - 0.05, (cos_port.mean(), cos_ct.mean())


def test_train_step_f32_matches_jax():
    """One plain-path f32 step against the JAX task's, weight decay on (so
    the conv biases that train-mode BatchNorm cancels still move) and a
    loss buffer already holding losses."""
    cfg, params, state = jax_weights()
    hp = dict(TASK, ct_kernels="off", weight_decay=1e-4,
              input_repetition_probability=0.0, scheduler_step_size=1,
              loss_buffer_temperature=0.5)
    spe, lr = 1, 1e-3
    rng = np.random.default_rng(12)
    batch = {
        "image": rng.integers(0, 256, (1, 32, 256, 3), dtype=np.uint8),
        "label": rng.uniform(0, 1, (1, 32, 256, 1)).astype(np.float32),
        "mask": (rng.uniform(0, 1, (1, 32, 256, 1)) > 0.2).astype(np.uint8),
    }
    lb = JaxLossBuffer(buffer=jnp.asarray(rng.uniform(0.5, 2.0, (10, 2)),
                                          jnp.float32),
                       index=jnp.asarray(3, jnp.int32))

    jtask = JaxTask(**hp)
    tx = jtask.make_optimizer(spe)
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                      model_state=state, opt_state=tx.init(params),
                      loss_buffer=lb)
    jnew, jlogs, jout = jax.jit(functools.partial(
        jtask.train_step, tx, with_outputs=True))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.key(0))
    mu = next(s.mu for s in jnew.opt_state if hasattr(s, "mu"))

    task = MimoUnetTask(**hp)
    model = torch_model(dataclasses.asdict(task.model_config), params, state)
    opt, sched = task.make_optimizer(model.train(), spe)
    tstate = TrainState(step=0, model=model, optimizer=opt, scheduler=sched,
                        loss_buffer=jax_loss_buffer_to_state(lb),
                        generator=torch.Generator().manual_seed(0))
    tstate, logs, out = task.train_step(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()},
        with_outputs=True)

    assert tstate.step == int(jnew.step) == 1
    assert logs.keys() == jlogs.keys()
    for k in logs:
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]), rtol=2e-4,
                                   atol=2e-4, err_msg=k)
    assert out.keys() == jout.keys()
    for k in out:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]),
                                   rtol=2e-4, atol=2e-4, err_msg=k)
    names = dict(model.named_parameters())
    mu = _param_dict(mu, jnew.model_state, cfg)
    new_params = _param_dict(jnew.params, jnew.model_state, cfg)
    for k, p in names.items():
        m = opt.state[p]["exp_avg"].numpy()
        scale = float(np.max(np.abs(mu[k])))
        np.testing.assert_allclose(m, mu[k], atol=1e-4 * scale + 1e-12, rtol=0,
                                   err_msg=k)
        # Adam's first step moves each weight by lr * g / (|g| + 1e-8),
        # about lr * sign(g): held tight where the gradient stands clear of
        # rounding noise and of Adam's epsilon, within the step's size
        # elsewhere
        strong = np.abs(mu[k]) > max(1e-3 * scale, 0.1 * 1e-5)
        got, want = p.detach().numpy(), new_params[k]
        np.testing.assert_allclose(got[strong], want[strong], atol=1e-6,
                                   rtol=0, err_msg=k)
        assert np.all(np.abs(got - want) <= 2 * lr + 1e-6), k
    got = _running_stats(model.state_dict())
    want = _running_stats(jax_pytree_to_state_dict(jnew.params,
                                                   jnew.model_state, cfg))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=2e-4, rtol=0,
                                   err_msg=k)
    np.testing.assert_allclose(tstate.loss_buffer.buffer.numpy(),
                               np.asarray(jnew.loss_buffer.buffer), atol=2e-4)
    assert tstate.loss_buffer.index == int(jnew.loss_buffer.index) == 4
    # StepLR by epoch: the next step runs at the schedule's rate for step 1
    assert opt.param_groups[0]["lr"] == pytest.approx(float(
        step_lr_schedule(lr, 1, 0.5, spe)(1)))


@pytest.mark.parametrize("steps_per_epoch,step_size", [(1, 1), (3, 2), (5, 20)])
def test_step_lr_factor_matches_jax(steps_per_epoch, step_size):
    sched = step_lr_schedule(1e-3, step_size, 0.5, steps_per_epoch)
    factor = step_lr_factor(step_size, 0.5, steps_per_epoch)
    for step in range(0, 130, 7):
        assert 1e-3 * factor(step) == pytest.approx(float(sched(step)))


@pytest.mark.parametrize("size", [0, 3])
def test_loss_buffer_matches_jax(size):
    rng = np.random.default_rng(size)
    losses = rng.uniform(0.1, 3.0, (5, 2)).astype(np.float32)
    jstate = JaxLossBuffer(buffer=jnp.zeros((max(size, 1), 2), jnp.float32),
                           index=jnp.zeros((), jnp.int32))
    state = loss_buffer_init(2, size, "cpu")
    for row in losses:
        np.testing.assert_allclose(
            loss_buffer_weights(state, 0.7, size).numpy(),
            np.asarray(jax_lb_weights(jstate, 0.7, size)), rtol=1e-6)
        jstate = jax_lb_add(jstate, jnp.asarray(row), size)
        state = loss_buffer_add(state, torch.from_numpy(row), size)
        np.testing.assert_array_equal(state.buffer.numpy(),
                                      np.asarray(jstate.buffer))
        assert state.index == int(jstate.index)


def test_input_transform_semantics():
    """reference utils.py:27-35: a main permutation tiled `reps` times;
    its first (1 - p) share re-shuffled per subnetwork, the tail shared."""
    b, s, reps, p = 8, 3, 2, 0.25
    image = torch.arange(b, dtype=torch.float32).view(b, 1, 1, 1).expand(b, 2, 2, 3)
    label = image[..., :1] * 10
    img_t, lab_t, mask_t = apply_input_transform(
        torch.Generator().manual_seed(0), image, label, None, s, p, reps)
    assert img_t.shape == (b * reps, s, 2, 2, 3) and mask_t is None
    idx = img_t[:, :, 0, 0, 0].long()  # [B*reps, S]
    assert torch.equal(lab_t[:, :, 0, 0, 0], idx.float() * 10)
    shuffled = int(b * reps * (1 - p))
    for j in range(s):
        assert sorted(idx[:, j].tolist()) == sorted(list(range(b)) * reps)
        assert torch.equal(idx[shuffled:, j], idx[shuffled:, 0])
    assert not all(torch.equal(idx[:, j], idx[:, 0]) for j in range(1, s))


@pytest.mark.parametrize("kw,shape,want", [
    (dict(), SHAPE, True),
    (dict(), (2, 2, 480, 640, 3), True),           # NYUv2 frames
    (dict(), (2, 2, 32, 128, 3), True),            # half width 64: same route
    (dict(), (2, 2, 256, 256, 3), True),           # flagship patches: one route
    (dict(), (2, 2, 40, 128, 3), False),           # H % 16
    (dict(), (2, 2, 48, 48, 3), True),             # partial kernel tiles
    (dict(ct_kernels="auto"), SHAPE, False),       # CPU: auto never takes it
    (dict(ct_kernels="off"), SHAPE, False),
    (dict(compute_dtype=None), SHAPE, False),      # bf16 only
    (dict(decoder_dropout_rate=0.1), SHAPE, True),   # dropout sites
    (dict(remat="enc"), SHAPE, True),              # remat: every rung
    (dict(filter_base_count=48), SHAPE, True),     # decoder C_in 144 <= 256
    (dict(filter_base_count=40), SHAPE, True),     # down1's 2F = 80 <= 256
    # BASELINE configs 5a and 5b: S=3 and S=4 at fbc 30 (decoder C_in 120
    # and 150, mid 60 and 75)
    (dict(num_subnetworks=3, filter_base_count=30), (2, 3, 32, 256, 3), True),
    (dict(num_subnetworks=4, filter_base_count=30), (2, 4, 32, 256, 3), True),
])
def test_train_path_routing(kw, shape, want):
    cfg = MimoUNetConfig(**{**BASE, "compute_dtype": "bfloat16",
                            "ct_kernels": "force", **kw})
    assert train_path_supported(cfg, shape, torch.device("cpu"),
                                training=True) is want
    assert not train_path_supported(cfg, shape, torch.device("cpu"),
                                    training=False)


@pytest.mark.parametrize("kw", [dict(bilinear=False)])
def test_train_forward_raises_for_unported_options(kw):
    """The one refused up-mode option is bilinear together with
    use_pooling_indices, as in the JAX package; the transpose and unpool
    modes (ROADMAP A.5, tests/test_torch_up_modes.py) and remat
    (tests/test_torch_remat.py) run on the plain route, a train forward
    with either ``ct_kernels``."""
    with pytest.raises(ValueError, match="use_pooling_indices and bilinear"):
        MimoUNetConfig(**dict(BASE, use_pooling_indices=True))
    for ct in ("force", "off"):
        model = MimoUNet(MimoUNetConfig(**dict(BASE, ct_kernels=ct, **kw)),
                         device="cpu").train()
        y = model(torch.zeros(1, 2, 32, 128, 3))
        assert y.shape == (1, 2, 32, 128, 2) and bool(torch.isfinite(y).all())


def test_entry_points_default_to_cuda(monkeypatch):
    """No device means the card: without one the entry points raise
    instead of building on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    task = MimoUnetTask(**TASK)
    with pytest.raises(RuntimeError, match="CUDA"):
        task.build_model()
    with pytest.raises(RuntimeError, match="CUDA"):
        task.init_state(steps_per_epoch=10)
    with pytest.raises(RuntimeError, match="CUDA"):
        MimoUNet(task.model_config)
    assert next(task.build_model("cpu").parameters()).device.type == "cpu"
