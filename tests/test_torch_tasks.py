"""The port's losses, uncertainty decomposition, metrics, validation step and
ensemble held against the JAX package (CPU, float32).

Same numpy inputs into both; model weights transplanted from the JAX
package's pytree (see tests/test_torch_slice.py).
"""

import copy
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimo_unet_tpu.losses import UncertaintyLoss as JaxLoss
from mimo_unet_tpu.metrics import compute_regression_metrics as jax_metrics
from mimo_unet_tpu.tasks.mimo import MimoUnetTask as JaxTask
from mimo_unet_tpu.transforms import (
    compute_uncertainties as jax_uncertainties,
    repeat_subnetworks as jax_repeat,
)

from mimo_unet_torch.losses import UncertaintyLoss
from mimo_unet_torch.metrics import compute_regression_metrics
from mimo_unet_torch.models.ensemble import Ensemble
from mimo_unet_torch.tasks.mimo import MimoUnetTask
from mimo_unet_torch.transforms import compute_uncertainties

from test_torch_slice import BASE, jax_weights, torch_model

RTOL = 1e-5


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def _data(seed, shape=(2, 3, 4, 5, 1)):
    rng = np.random.default_rng(seed)
    p1 = rng.normal(0, 1, shape).astype(np.float32)
    p2 = rng.normal(0, 1.5, shape).astype(np.float32)  # log-params
    y = rng.normal(0, 1, shape).astype(np.float32)
    mask = (rng.uniform(0, 1, shape) > 0.3).astype(np.float32)
    return p1, p2, y, mask


@pytest.mark.parametrize("name", ["laplace_nll", "gaussian_nll"])
def test_losses_match_jax(name):
    p1, p2, y, mask = _data(0)
    jl, tl = JaxLoss.from_name(name), UncertaintyLoss.from_name(name)
    assert tl.name == jl.name
    t = [torch.from_numpy(a) for a in (p1, p2, y, mask)]
    j = [jnp.asarray(a) for a in (p1, p2, y, mask)]
    for kw in (dict(mask=None, reduce_mean=True),
               dict(mask="m", reduce_mean=False)):
        tm, jm = (t[3], j[3]) if kw["mask"] else (None, None)
        got = tl(*t[:3], mask=tm, reduce_mean=kw["reduce_mean"])
        want = jl(*j[:3], mask=jm, reduce_mean=kw["reduce_mean"])
        np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(_np(tl.mode(t[0], t[1])), _np(jl.mode(j[0], j[1])))
    np.testing.assert_allclose(_np(tl.std(t[0], t[1])), _np(jl.std(j[0], j[1])),
                               rtol=RTOL)
    std = np.abs(p1) + 1e-3
    for log in (False, True):
        np.testing.assert_allclose(
            _np(tl.calculate_dist_param(torch.from_numpy(std), log=log)),
            _np(jl.calculate_dist_param(jnp.asarray(std), log=log)),
            rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("name", ["laplace_nll", "gaussian_nll"])
def test_loss_clamp_at_exp_overflow(name):
    """ROADMAP C.6: where exp(log-param) overflows f32 (log-param > 88.7)
    the reference's in-place clamp gives the loss at eps_max; the
    straight-through composition the JAX package uses gives NaN there.
    Elsewhere the port's loss and gradient are the JAX package's."""
    loss = UncertaintyLoss.from_name(name)
    x = torch.tensor([100.0, -200.0, 0.5, 8.0], requires_grad=True)
    mu, y = torch.zeros(4), torch.full((4,), 0.25)
    per = loss(mu, x, y, reduce_mean=False)
    eps_max = 1e3
    assert torch.isfinite(per).all()
    want = math.log(eps_max) + (0.25 / eps_max if name == "laplace_nll"
                                else 0.25 ** 2 / eps_max)
    assert float(per[0].detach()) == pytest.approx(want, rel=1e-6)
    per[2:].sum().backward()
    xj = jnp.asarray(x.detach().numpy()[2:])
    gj = jax.grad(lambda a: JaxLoss.from_name(name)(
        jnp.zeros(2), a, jnp.full((2,), 0.25), reduce_mean=False).sum())(xj)
    np.testing.assert_allclose(_np(x.grad[2:]), np.asarray(gj), rtol=RTOL)
    assert bool(jnp.isnan(JaxLoss.from_name(name)(
        jnp.zeros(1), jnp.asarray([100.0]), jnp.full((1,), 0.25))))


@pytest.mark.parametrize("s", [1, 3])
def test_compute_uncertainties_match_jax(s):
    p1, p2, _, _ = _data(1, (2, s, 4, 5, 1))
    for name in ("laplace_nll", "gaussian_nll"):
        got = compute_uncertainties(UncertaintyLoss.from_name(name),
                                    torch.from_numpy(p1), torch.from_numpy(p2))
        want = jax_uncertainties(JaxLoss.from_name(name), jnp.asarray(p1),
                                 jnp.asarray(p2))
        for a, b in zip(got, want):
            np.testing.assert_allclose(_np(a), _np(b), rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("weighted", [False, True])
def test_regression_metrics_match_jax(weighted):
    y_hat, _, y, _ = _data(2, (3, 4, 5, 1))
    w = np.array([1.0, 0.0, 1.0], np.float32).reshape(3, 1, 1, 1)
    metrics = ["r2", "mae", "mse", "rmse", "mape"]
    got = compute_regression_metrics(
        torch.from_numpy(y_hat), torch.from_numpy(y), metrics,
        torch.from_numpy(w) if weighted else None)
    want = jax_metrics(jnp.asarray(y_hat), jnp.asarray(y), metrics,
                       jnp.asarray(w) if weighted else None)
    assert got.keys() == want.keys()
    for k in metrics:
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), rtol=RTOL)


TASK = dict(in_channels=3, out_channels=2, num_subnetworks=2,
            filter_base_count=6, loss="laplace_nll")


def _close(got, want, rtol=1e-4):
    """1e-4 relative, with an absolute floor of 1e-4 of the largest value
    (variances of near-equal predictions have no relative accuracy)."""
    want = _np(want)
    scale = float(np.max(np.abs(want))) if want.size else 1.0
    np.testing.assert_allclose(_np(got), want, rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("valid", [None, [1, 1, 0]])
def test_val_step_matches_jax(valid):
    """Plain f32 model: logs and outputs of val_step, uint8 images (the
    /255 of device_normalize) and a mask, with and without padded rows."""
    _, params, state = jax_weights()
    rng = np.random.default_rng(3)
    batch = {
        "image": rng.integers(0, 256, (3, 32, 256, 3), dtype=np.uint8),
        "label": rng.uniform(0, 1, (3, 32, 256, 1)).astype(np.float32),
        "mask": (rng.uniform(0, 1, (3, 32, 256, 1)) > 0.2).astype(np.uint8),
    }
    if valid is not None:
        batch["valid"] = np.asarray(valid, np.float32)
    jtask = JaxTask(**TASK, ct_kernels="off")
    logs_j, out_j = jax.jit(jtask.val_step)(
        params, state, {k: jnp.asarray(v) for k, v in batch.items()})
    task = MimoUnetTask(**TASK, ct_kernels="off")
    model = torch_model(dataclasses.asdict(task.model_config), params, state)
    logs, out = task.val_step(model, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    assert logs.keys() == logs_j.keys()
    for k in logs:
        _close(logs[k], logs_j[k])
    for k in ("label", "preds", "aleatoric_std_map", "epistemic_std_map",
              "err_map"):
        _close(out[k], out_j[k])


def test_ensemble_predict_matches_jax():
    """Ensemble.predict (batch 2 over 3 images: the last batch padded) vs
    the JAX task forward on repeated inputs + compute_uncertainties."""
    _, params, state = jax_weights()
    images = np.random.default_rng(4).uniform(0, 1, (3, 32, 256, 3)).astype(
        np.float32)
    jtask = JaxTask(**TASK, ct_kernels="off")
    fwd = jax.jit(functools.partial(jtask.forward, train=False))
    (p1, p2), _ = fwd(params, state, jax_repeat(jnp.asarray(images), 2))
    want = jax_uncertainties(jtask.loss_fn, p1, p2)

    task = MimoUnetTask(**TASK, ct_kernels="off")
    model = torch_model(dataclasses.asdict(task.model_config), params, state)
    got = Ensemble([(task, model)]).predict(images, batch_size=2)
    for a, b in zip(got, want):
        assert a.shape == (3, 32, 256, 1)
        _close(a, b)
    assert np.all(got[1] >= 0) and np.all(got[2] >= 0)


# ---- validation and serving run in eval mode, whatever mode the model is in

def _trained(**rates):
    """The plain f32 task (S=2, fbc 6) after one train_step at 32x32 on
    the CPU: its model is left in train mode, as train_step leaves it."""
    task = MimoUnetTask(**TASK, ct_kernels="off", **rates)
    state = task.init_state(4, device="cpu")
    rng = np.random.default_rng(7)
    batch = {"image": torch.from_numpy(rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)),
             "label": torch.from_numpy(rng.uniform(0, 1, (2, 32, 32, 1)).astype(np.float32))}
    task.train_step(state, batch)
    assert all(m.training for m in state.model.modules())
    return task, state.model, batch


def _buffers(model):
    return {k: v.clone() for k, v in model.named_buffers()}


def _assert_unmoved(model, before):
    """Every BatchNorm buffer bitwise as it was, the model still in train
    mode."""
    assert all(m.training for m in model.modules())
    now = dict(model.named_buffers())
    assert now.keys() == before.keys() and len(now) == 72
    moved = [k for k, v in now.items() if not torch.equal(v, before[k])]
    assert not moved, moved


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_val_step_after_train_step_runs_in_eval_mode(rate):
    """val_step right after a train_step (decoder dropout off and on):
    no BatchNorm buffer moves, the logs and outputs are an eval-mode
    copy's, bitwise, and the model is still in train mode."""
    task, model, batch = _trained(decoder_dropout_rate=rate)
    before = _buffers(model)
    ref = copy.deepcopy(model).eval()
    logs, out = task.val_step(model, batch)
    _assert_unmoved(model, before)
    logs_ref, out_ref = task.val_step(ref, batch)
    assert logs.keys() == logs_ref.keys()
    for k in logs:
        assert torch.equal(logs[k], logs_ref[k]), k
    for k in ("preds", "aleatoric_std_map", "epistemic_std_map"):
        assert torch.equal(out[k], out_ref[k]), k


@pytest.mark.parametrize("rate, mc", [(0.0, 0), (0.1, 2)])
def test_ensemble_predict_on_a_train_mode_member(rate, mc):
    """Ensemble.predict on the member train_step left in train mode (3
    images in batches of 2: the last one padded; with and without MC
    passes): no BatchNorm buffer moves, the model stays in train mode, and
    the predictions are an eval-mode copy's, bitwise."""
    task, model, _ = _trained(decoder_dropout_rate=rate)
    before = _buffers(model)
    images = np.random.default_rng(8).uniform(0, 1, (3, 32, 32, 3)).astype(np.float32)
    got = Ensemble([(task, model)], monte_carlo_steps=mc).predict(images, batch_size=2)
    _assert_unmoved(model, before)
    want = Ensemble([(task, copy.deepcopy(model).eval())],
                    monte_carlo_steps=mc).predict(images, batch_size=2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
