"""The port's evidential (NIG) task held against the JAX package (CPU).

Shape: fbc 6, S=1, 4 outputs, B=2, 32x256 (at 16 rows the core's
bottleneck is one row high, see tests/test_torch_slice.py); weights are the
JAX package's pytree filled with seeded numpy values and transplanted with
``jax_pytree_to_state_dict``.

* The NIG loss and its three variance maps, values and gradients, with and
  without a mask, at 1e-5, and where ``exp(lgamma)`` overflows.
* ``EvidentialUnetTask.forward`` in f32 on the plain modules at 2e-4.
* The kernel route at S=1, OC=4 (``ct_kernels="force"``, bf16: on the CPU
  every kernel wrapper runs its plain version) against the JAX task on its
  Pallas kernels in interpret mode: the eval forward to 1e-2 * max|ref|,
  the train forward by mean error and distance from the f32 truth, the
  BatchNorm statistics, and the gradients by cosine against the f32
  gradients, as tests/test_torch_train.py holds the flagship's; and the
  route's wrapper calls, a train step's and an eval forward's.
* One f32 ``train_step`` (loss, logs, Adam's moments, parameters,
  BatchNorm state) and ``val_step`` with padded ``valid`` rows.
* Checkpoints: ``Trainer.fit`` of the evidential task, ``load_checkpoint``
  and resume, bitwise; a reference Lightning ``.ckpt`` of either family
  against the JAX package's ``load_checkpoint`` of the same file.
"""

import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimo_unet_tpu.loss_buffer import loss_buffer_init as jax_loss_buffer_init
from mimo_unet_tpu.losses import EvidentialLoss as JaxEvidentialLoss
from mimo_unet_tpu.models.mimo_unet import mimo_unet_init
from mimo_unet_tpu.tasks.evidential import EvidentialUnetTask as JaxEvTask
from mimo_unet_tpu.tasks.mimo import MimoUnetTask as JaxMimoTask, TrainState as JaxState
from mimo_unet_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint

from mimo_unet_torch import kernels as K
from mimo_unet_torch.interop import jax_pytree_to_state_dict
from mimo_unet_torch.losses import EvidentialLoss
from mimo_unet_torch.models.fast_path import fast_path_supported, train_path_supported
from mimo_unet_torch.tasks import EvidentialUnetTask, MimoUnetTask
from mimo_unet_torch.train import checkpoint

from test_torch_slice import _leaf_values, torch_model
from test_torch_train import _cosines, _param_dict, _running_stats
from test_torch_trainer import _assert_states_equal, _trainer

SHAPE = (2, 32, 256, 3)  # B, H, W, C
EV = dict(in_channels=3, filter_base_count=6)
KERNEL = dict(ct_kernels="force", compute_dtype="bfloat16")
# a train step's and an eval forward's kernel calls on the route
# (chip_smoke.py STEP_LAUNCHES and EVAL_LAUNCHES)
STEP_CALLS = {"conv3x3_fwd": 6, "conv3x3_dx": 4, "conv3x3_dx_fold": 1, "conv3x3_dw": 6,
              "g_eff": 6, "affine_relu": 2, "affine_relu_bwd": 2, "conv1x1_prelu": 1,
              "conv1x1_prelu_bwd": 1, "max_pool2x2": 2, "max_pool2x2_bwd": 2,
              "upsample2x": 1, "upsample2x_bwd": 1}
EVAL_CALLS = {"fused_double_conv9": 1, "fused_double_conv": 3, "pool_w": 2,
              "upsample_w2x": 2}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small shapes: torch's intra-op threads cost more than they give,
    most of all beside other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def ev_weights(seed=0, filter_base_count=6, out_channels=4, num_subnetworks=1):
    """(jax cfg, params, state) of a MimoUNet of ``num_subnetworks`` (the
    evidential task's at 1) filled with seeded numpy values, BatchNorm
    statistics and affine included."""
    cfg = dataclasses.replace(
        JaxEvTask(**dict(EV, filter_base_count=filter_base_count,
                         out_channels=out_channels)).model_config,
        num_subnetworks=num_subnetworks)
    shapes = jax.eval_shape(lambda k: mimo_unet_init(k, cfg), jax.random.key(seed))
    rng = np.random.default_rng(seed)
    params, state = jax.tree_util.tree_map_with_path(
        lambda path, sd: jnp.asarray(_leaf_values(path, sd.shape, rng), sd.dtype),
        shapes)
    return cfg, params, state


def port_model(task, params, state):
    return torch_model(dataclasses.asdict(task.model_config), params, state)


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, SHAPE).astype(np.float32),
            rng.uniform(0, 1, SHAPE[:3] + (1,)).astype(np.float32))


# ------------------------------------------------------------------ the loss

def _nig(seed, shape=(2, 5, 6), alpha_hi=5.0):
    rng = np.random.default_rng(seed)
    out = np.stack([rng.normal(0, 1, shape), rng.uniform(0.1, 2.0, shape),
                    rng.uniform(1.1, alpha_hi, shape), rng.uniform(0.1, 2.0, shape)],
                   axis=-1).astype(np.float32)
    y = rng.normal(0, 1, shape + (1,)).astype(np.float32)
    mask = (rng.uniform(0, 1, shape) > 0.3).astype(np.float32)
    return out, y, mask


@pytest.mark.parametrize("masked", [False, True])
def test_nig_loss_and_variances_match_jax(masked):
    out, y, mask = _nig(0)
    jl, tl = JaxEvidentialLoss(), EvidentialLoss()
    assert tl.name == jl.name == "evidential"
    jm, tm = (jnp.asarray(mask), torch.from_numpy(mask)) if masked else (None, None)
    for reduce_mean in (False, True):
        want = jl(jnp.asarray(out), jnp.asarray(y), mask=jm, reduce_mean=reduce_mean)
        got = tl(torch.from_numpy(out), torch.from_numpy(y), mask=tm,
                 reduce_mean=reduce_mean)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    g_want = jax.grad(lambda o: jl(o, jnp.asarray(y), mask=jm, reduce_mean=True))(
        jnp.asarray(out))
    t = torch.from_numpy(out).requires_grad_()
    tl(t, torch.from_numpy(y), mask=tm, reduce_mean=True).backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(g_want), rtol=1e-5,
                               atol=1e-5 * float(np.abs(g_want).max()))
    for fn in ("mode", "aleatoric_var", "epistemic_var"):
        np.testing.assert_allclose(getattr(tl, fn)(torch.from_numpy(out)).numpy(),
                                   np.asarray(getattr(jl, fn)(jnp.asarray(out))),
                                   rtol=1e-5, err_msg=fn)


def test_nig_loss_overflow_matches_jax():
    """alpha up to 60: exp(lgamma(alpha)) overflows float32 past alpha ~ 35,
    and the ratio is then NaN in both packages, where a stabilised form
    would give a number.  Elsewhere 1e-4: near the overflow lgamma is
    ~150, and exp turns its last-ulp difference (1e-5 absolute) into a
    1e-5 relative one."""
    out, y, _ = _nig(1, alpha_hi=60.0)
    want = np.asarray(JaxEvidentialLoss()(jnp.asarray(out), jnp.asarray(y)))
    got = EvidentialLoss()(torch.from_numpy(out), torch.from_numpy(y)).numpy()
    assert np.isnan(want).any() and np.isfinite(want).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-4, equal_nan=True)


# ------------------------------------------------------------------ forward

def test_forward_f32_matches_jax():
    cfg, params, state = ev_weights()
    x, _ = _inputs()
    jtask = JaxEvTask(**EV, ct_kernels="off")
    want, _ = jax.jit(functools.partial(jtask.forward, train=False))(
        params, state, jnp.asarray(x))
    task = EvidentialUnetTask(**EV, ct_kernels="off")
    with torch.no_grad():
        got = task.forward(port_model(task, params, state), torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == SHAPE[:3] + (4,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)
    assert float(got[..., 2].min()) > 1.0 and float(got[..., 1].min()) >= 0


@pytest.fixture(scope="module")
def kernel_run():
    """The JAX task on its Pallas kernels in interpret mode (an eval
    forward; a train forward with the gradient of the NIG loss), its f32
    XLA path, and the port's kernel route, on the same weights."""
    cfg, params, state = ev_weights()
    x, y = (jnp.asarray(a) for a in _inputs())
    loss = JaxEvidentialLoss()
    jtasks = {"ct": JaxEvTask(**EV, **KERNEL), "32": JaxEvTask(**EV, ct_kernels="off")}
    r = {}
    for name, jt in jtasks.items():
        r[f"eval{name}"] = np.asarray(jax.jit(functools.partial(
            jt.forward, train=False))(params, state, x)[0])

    def objective(jt):
        def f(p):
            out, new_state = jt.forward(p, state, x, train=True)
            return loss(out, y, reduce_mean=True), (out, new_state)
        return jax.jit(jax.value_and_grad(f, has_aux=True))

    for name in ("ct", "32"):
        (_, (out, st)), g = objective(jtasks[name])(params)
        r[f"train{name}"] = np.asarray(out)
        r[f"g{name}"] = _param_dict(g, state, cfg)
        r[f"st{name}"] = _running_stats(jax_pytree_to_state_dict(params, st, cfg))

    task = EvidentialUnetTask(**EV, **KERNEL)
    model = port_model(task, params, state)
    xt, yt = (torch.from_numpy(np.array(a)) for a in (x, y))
    assert fast_path_supported(task.model_config, (2, 1) + SHAPE[1:], xt.device,
                               training=False)
    assert train_path_supported(task.model_config, (2, 1) + SHAPE[1:], xt.device,
                                training=True)
    with torch.no_grad():
        r["eval_port"] = task.forward(model, xt).numpy()
    model.train()
    out = task.forward(model, xt)
    task.loss_fn(out, yt, reduce_mean=True).backward()
    r["train_port"] = out.detach().numpy()
    r["g_port"] = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
                   for k, p in model.named_parameters()}
    r["st_port"] = _running_stats(model.state_dict())
    return r


def test_kernel_route_eval_forward_matches_jax_kernels(kernel_run):
    """bf16 eval forward at S=1, OC=4 against the JAX Pallas kernels:
    <= 1e-2 * max|ref| (test_torch_slice.py's bound), no farther from the
    f32 truth than the JAX package's own kernels are."""
    r = kernel_run
    want, got = r["evalct"], r["eval_port"]
    assert got.shape == want.shape == SHAPE[:3] + (4,)
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(got, want, atol=1e-2 * scale, rtol=0)
    e_ref = float(np.mean(np.abs(want - r["eval32"])))
    e_port = float(np.mean(np.abs(got - r["eval32"])))
    assert e_port < 1.3 * e_ref + 1e-4, (e_port, e_ref)


def test_kernel_route_train_matches_jax_kernels(kernel_run):
    """The train forward's output by mean abs error (through the
    train-mode BatchNorms one bf16 ulp grows; test_torch_train.py), the
    running statistics within 5e-3, and the gradients by cosine against
    the f32 XLA gradients, no worse than the JAX kernel path's own up to
    test_ct_train.py's slack."""
    r = kernel_run
    want, got = r["trainct"], r["train_port"]
    scale = float(np.max(np.abs(want)))
    assert float(np.mean(np.abs(got - want))) <= 1e-2 * scale
    e_ref = float(np.mean(np.abs(want - r["train32"])))
    e_port = float(np.mean(np.abs(got - r["train32"])))
    assert e_port < 1.3 * e_ref + 1e-4, (e_port, e_ref)
    assert r["st_port"].keys() == r["stct"].keys()
    for k in r["stct"]:
        np.testing.assert_allclose(r["st_port"][k], r["stct"][k], atol=5e-3,
                                   rtol=0, err_msg=k)
    assert r["g_port"].keys() == r["g32"].keys()
    cos_ct, cos_port = _cosines(r["g32"], r["gct"]), _cosines(r["g32"], r["g_port"])
    assert len(cos_port) == len(cos_ct) > 0
    assert cos_port.min() > cos_ct.min() - 0.15, (cos_port.min(), cos_ct.min())
    assert cos_port.mean() > cos_ct.mean() - 0.05, (cos_port.mean(), cos_ct.mean())


def _count_kernel_calls(monkeypatch):
    """Count each kernel wrapper's calls on the CPU: the calls of its plain
    version made by the wrapper itself (a launch on the card)."""
    calls = {k.__name__: 0 for k in K.KERNELS}
    for k in K.KERNELS:
        mod = sys.modules[k.__module__]
        plain = getattr(mod, f"{k.__name__}_plain")

        def counted(*args, _name=k.__name__, _plain=plain, **kw):
            if sys._getframe(1).f_code.co_name == _name:
                calls[_name] += 1
            return _plain(*args, **kw)

        monkeypatch.setattr(mod, f"{k.__name__}_plain", counted)
    return calls


def test_kernel_route_calls_every_kernel_at_s1(monkeypatch):
    """At S=1, OC=4 a train step and an eval forward call each kernel of
    the route as often as the flagship's do (phase 11's counts), and no
    other kernel; no launch on the CPU."""
    calls = _count_kernel_calls(monkeypatch)
    task = EvidentialUnetTask(**dict(EV, filter_base_count=4), **KERNEL)
    state = task.init_state(1, "cpu")
    rng = np.random.default_rng(2)
    batch = {"image": torch.from_numpy(rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)),
             "label": torch.from_numpy(rng.uniform(0, 1, (2, 32, 32, 1)).astype(np.float32))}
    K.reset_launch_counts()
    task.train_step(state, batch)
    assert {k: v for k, v in calls.items() if v} == STEP_CALLS
    calls.update({k: 0 for k in calls})
    task.val_step(state.model, batch)
    assert {k: v for k, v in calls.items() if v} == EVAL_CALLS
    assert set(K.launch_counts().values()) == {0}


# ------------------------------------------------------------------ steps

def _batch(seed, b=2, valid=None):
    rng = np.random.default_rng(seed)
    batch = {"image": rng.integers(0, 256, (b,) + SHAPE[1:], dtype=np.uint8),
             "label": rng.uniform(0, 1, (b,) + SHAPE[1:3] + (1,)).astype(np.float32),
             "mask": (rng.uniform(0, 1, (b,) + SHAPE[1:3] + (1,)) > 0.2).astype(np.uint8)}
    if valid is not None:
        batch["valid"] = np.asarray(valid, np.float32)
    return batch


def _kinks(task, params, state, image):
    """(ReLU inputs within 1e-6 of their layer's largest |value| of 0, 2x2
    pool windows whose two largest values are within 1e-5 relative) in the
    port's f32 train-mode forward of uint8 ``image``."""
    import torch.nn.functional as F

    relu, pool = torch.relu, F.max_pool2d
    found = [0, 0]

    def near_zero(y):
        a = y.detach().abs()
        found[0] += int((a < 1e-6 * a.max()).sum())
        return relu(y)

    def near_tie(t, k):
        n, c, h, w = t.shape
        top = (t.detach().reshape(n, c, h // 2, 2, w // 2, 2).permute(0, 1, 2, 4, 3, 5)
               .reshape(n, c, h // 2, w // 2, 4).topk(2, dim=-1).values)
        rel = (top[..., 0] - top[..., 1]) / top[..., 0].abs().clamp_min(1e-30)
        found[1] += int(((rel < 1e-5) & (top[..., 0] > 0)).sum())
        return pool(t, k)

    model = port_model(task, params, state).train()
    torch.relu, F.max_pool2d = near_zero, near_tie
    try:
        with torch.no_grad():
            model(torch.from_numpy(image).float()[:, None] / 255.0)
    finally:
        torch.relu, F.max_pool2d = relu, pool
    return tuple(found)


def test_train_step_f32_matches_jax():
    """One plain-route f32 step with weight decay and a mask: loss, logs,
    the step's outputs, Adam's first moments (0.1 * gradient), parameters
    and BatchNorm state, to docs/PARITY.md's 2e-4 forward / 1e-4 gradient
    bounds.

    The gradient of a ReLU network is not continuous where a ReLU input
    sits at 0 or a 2x2 pool window is tied: an input within rounding of
    such a point takes one side in one f32 implementation and the other
    in the next (at the first draws tried, one down1 ReLU input at 1e-7 of
    its layer's scale moved the encoder's gradients by up to 6e-3 of their
    largest value, while the port's f32 and f64 runs agreed to 5e-6).  So
    the draw is one with no such point, checked here on the port's forward
    (``_kinks``): B=1, as tests/test_torch_train.py's step."""
    cfg, params, state = ev_weights()
    hp = dict(EV, ct_kernels="off", weight_decay=1e-4, scheduler_step_size=1)
    batch = _batch(20, b=1)
    assert _kinks(EvidentialUnetTask(**hp), params, state, batch["image"]) == (0, 0)
    jtask = JaxEvTask(**hp)
    tx = jtask.make_optimizer(1)
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=params, model_state=state,
                      opt_state=tx.init(params),
                      loss_buffer=jax_loss_buffer_init(1, 0))
    jnew, jlogs, jout = jax.jit(functools.partial(jtask.train_step, tx, with_outputs=True))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(0))
    mu = _param_dict(next(s.mu for s in jnew.opt_state if hasattr(s, "mu")),
                     jnew.model_state, cfg)

    task = EvidentialUnetTask(**hp)
    tstate = task.init_state(1, "cpu")
    tstate.model.load_state_dict(jax_pytree_to_state_dict(params, state, cfg))
    tstate, logs, out = task.train_step(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, with_outputs=True)
    assert tstate.step == int(jnew.step) == 1
    assert logs.keys() == jlogs.keys() and out.keys() == jout.keys()
    for k in logs:
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]), rtol=2e-4, atol=2e-4,
                                   err_msg=k)
    for k in out:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), rtol=2e-4,
                                   atol=2e-4, err_msg=k)
    new_params = _param_dict(jnew.params, jnew.model_state, cfg)
    for k, p in tstate.model.named_parameters():
        m = tstate.optimizer.state[p]["exp_avg"].numpy()
        scale = float(np.max(np.abs(mu[k])))
        np.testing.assert_allclose(m, mu[k], atol=1e-4 * scale + 1e-12, rtol=0, err_msg=k)
        # Adam's first step moves a weight by about lr * sign(g): tight where
        # the gradient stands clear of noise, within the step elsewhere
        strong = np.abs(mu[k]) > max(1e-3 * scale, 1e-6)
        got, want = p.detach().numpy(), new_params[k]
        np.testing.assert_allclose(got[strong], want[strong], atol=1e-6, rtol=0, err_msg=k)
        assert np.all(np.abs(got - want) <= 2e-3 + 1e-6), k
    got = _running_stats(tstate.model.state_dict())
    want = _running_stats(jax_pytree_to_state_dict(jnew.params, jnew.model_state, cfg))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=2e-4, rtol=0, err_msg=k)


@pytest.mark.parametrize("valid", [None, [1, 1, 0]])
def test_val_step_matches_jax(valid):
    """Plain f32: logs and outputs of val_step on uint8 images and a mask,
    with and without padded rows, 1e-4 relative (the variances' floor at
    1e-4 of their largest value)."""
    cfg, params, state = ev_weights()
    batch = _batch(3, b=3, valid=valid)
    jlogs, jout = jax.jit(JaxEvTask(**EV, ct_kernels="off").val_step)(
        params, state, {k: jnp.asarray(v) for k, v in batch.items()})
    task = EvidentialUnetTask(**EV, ct_kernels="off")
    logs, out = task.val_step(port_model(task, params, state).train(),
                              {k: torch.from_numpy(v) for k, v in batch.items()})
    assert logs.keys() == jlogs.keys()
    for k in logs:
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    for k in ("label", "preds", "aleatoric_std_map", "epistemic_std_map", "err_map"):
        want = np.asarray(jout[k])
        np.testing.assert_allclose(out[k].numpy(), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()), err_msg=k)


def test_hparams_match_jax():
    kw = dict(EV, decoder_dropout_rate=0.1, remat="enc", compute_dtype="bfloat16")
    assert EvidentialUnetTask(**kw).hparams() == JaxEvTask(**kw).hparams()


# ------------------------------------------------------------------ checkpoints

def test_fit_load_and_resume_bitwise(tmp_path):
    """Trainer.fit of the evidential task writes last/ and best/; loading
    last/ gives an EvidentialUnetTask and the trained state bit for bit;
    1 epoch then a resume to 2 is bitwise 2 straight epochs."""
    task = EvidentialUnetTask(in_channels=3, filter_base_count=4,
                              decoder_dropout_rate=0.1)
    straight = _trainer(tmp_path, "straight", 2, task).fit()
    for d in ("last", "best"):
        assert (tmp_path / "straight" / d / "state" / "state.pt").is_file()
    task2, loaded = checkpoint.load_checkpoint(str(tmp_path / "straight" / "last"), 4,
                                               device="cpu")
    assert task2 == task and isinstance(task2, EvidentialUnetTask)
    assert loaded.step == straight.step == 8
    _assert_states_equal(loaded, straight)
    _trainer(tmp_path, "resumed", 1, task).fit()
    resumed = _trainer(tmp_path, "resumed", 2, task).fit(resume=True)
    _assert_states_equal(resumed, straight)


def _reference_ckpt(path, family, with_task):
    """A reference-format Lightning .ckpt written from JAX-shaped seeded
    weights: 'model.' + '_orig_mod.' prefixed state-dict keys (a compiled
    module), the reference's hyper_parameters (``task`` added only with
    ``with_task``).  Returns the port task it should load as."""
    if family == "mimo":
        cfg, params, state = ev_weights(seed=4, out_channels=2)
        hp = dict(in_channels=3, out_channels=2, num_subnetworks=1, filter_base_count=6,
                  loss="laplace_nll", weight_decay=0.0, learning_rate=1e-3, seed=1,
                  loss_buffer_size=10, loss_buffer_temperature=1.0)
        want = MimoUnetTask(**{k: v for k, v in hp.items() if k != "task"})
    else:
        cfg, params, state = ev_weights(seed=5)
        hp = dict(in_channels=3, out_channels=4, num_subnetworks=1, filter_base_count=6,
                  weight_decay=0.0, learning_rate=1e-3, seed=2)
        if with_task:
            want = EvidentialUnetTask(**{k: v for k, v in hp.items()
                                         if k not in ("num_subnetworks",)})
        else:  # no task named: a 4-output MIMO task, as in the JAX package
            want = MimoUnetTask(**hp)
    if with_task:
        hp["task"] = "evidential_unet" if family == "evidential" else "mimo_unet"
    sd = jax_pytree_to_state_dict(params, state, want.model_config)
    torch.save({"state_dict": {f"model._orig_mod.{k}": v for k, v in sd.items()},
                "hyper_parameters": hp, "epoch": 3}, path)
    return want


@pytest.mark.parametrize("family,with_task", [("mimo", False), ("evidential", True),
                                              ("evidential", False)])
def test_reference_ckpt_matches_jax_load(tmp_path, family, with_task):
    """The port's load_checkpoint and the JAX package's of the same .ckpt
    give the same task class and fields and the same f32 forward (2e-4);
    the optimizer starts fresh."""
    path = str(tmp_path / "ref.ckpt")
    want = _reference_ckpt(path, family, with_task)
    task, state = checkpoint.load_checkpoint(path, device="cpu")
    jtask, jstate = jax_load_checkpoint(path)
    assert task == want and type(task).__name__ == type(jtask).__name__
    assert dataclasses.asdict(task) == dataclasses.asdict(jtask)
    assert state.step == 0 and not state.optimizer.state
    x, _ = _inputs(6)
    task, jtask = (dataclasses.replace(t, ct_kernels="off") for t in (task, jtask))
    jforward = jax.jit(functools.partial(jtask.forward, train=False))
    if isinstance(task, EvidentialUnetTask):
        want_out, _ = jforward(jstate.params, jstate.model_state, jnp.asarray(x))
        with torch.no_grad():
            got = task.forward(state.model.eval(), torch.from_numpy(x)).numpy()
    else:
        s = task.num_subnetworks
        xs = np.repeat(x[:, None], s, axis=1)
        (p1, p2), _ = jforward(jstate.params, jstate.model_state, jnp.asarray(xs))
        want_out = np.concatenate([np.asarray(p1), np.asarray(p2)], -1)
        with torch.no_grad():
            got = torch.cat(task.forward(state.model.eval(), torch.from_numpy(xs)),
                            -1).numpy()
    np.testing.assert_allclose(got, np.asarray(want_out), atol=2e-4, rtol=0)
    if family == "evidential" and not with_task:
        assert isinstance(task, MimoUnetTask) and task.out_channels == 4
        assert isinstance(jtask, JaxMimoTask)
