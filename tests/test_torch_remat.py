"""The port's remat rungs ("none", "enc", "all") on both train routes (CPU).

* Against the port itself: on the plain f32 route (``ct_kernels="off"``)
  and on the train kernel route (``ct_kernels="force"``: every kernel
  wrapper runs its plain version on the CPU), without dropout, with the MC
  recipe's Dropout2d sites and with the final dropout, two ``train_step``s
  at "enc" and at "all" give the loss, the gradients, the parameters and
  the BatchNorm buffers of "none" bit for bit, and ``num_batches_tracked``
  rises by exactly 1 a step.  The recompute really happens (the
  sections' convs run again in the backward) and what the forward keeps
  for the backward outside the sections shrinks rung by rung.
* Against the JAX package: the f32 MC-recipe step of
  tests/test_torch_dropout.py with ``remat`` set on both sides (the JAX
  key tree's masks injected), Adam's first moments (0.1 x the gradient)
  within docs/PARITY.md's 1e-4.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimo_unet_tpu.loss_buffer import LossBufferState as JaxLossBuffer
from mimo_unet_tpu.tasks.mimo import MimoUnetTask as JaxTask, TrainState as JaxState

from mimo_unet_torch.interop import jax_loss_buffer_to_state
from mimo_unet_torch.kernels import conv3x3_train
from mimo_unet_torch.models import blocks
from mimo_unet_torch.models.mimo_unet import MimoUNetConfig
from mimo_unet_torch.ops.dropout import DropoutSource
from mimo_unet_torch.tasks.mimo import MimoUnetTask, TrainState

from test_torch_dropout import MC, jax_masks, jit0
from test_torch_slice import BASE, jax_weights, torch_model
from test_torch_train import _param_dict

SMALL = dict(in_channels=3, out_channels=2, num_subnetworks=2,
             filter_base_count=4)
ROUTES = {"plain": dict(ct_kernels="off"),
          "kernel": dict(ct_kernels="force", compute_dtype="bfloat16")}
DROPOUT = {"none": {}, "mc": MC, "final": dict(final_dropout_rate=0.2)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These steps are small: torch's intra-op threads cost more than they
    give, most of all beside other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(n=2, b=2, hw=32):
    g = torch.Generator().manual_seed(3)
    return [{"image": torch.randint(0, 256, (b, hw, hw, 3), generator=g,
                                    dtype=torch.uint8),
             "label": torch.rand((b, hw, hw, 1), generator=g)}
            for _ in range(n)]


def _steps(remat, route, drop):
    """Two train steps from a seeded state: per step (loss, gradients), and
    the final parameters and buffers."""
    task = MimoUnetTask(**SMALL, remat=remat, **ROUTES[route], **DROPOUT[drop])
    state = task.init_state(2, "cpu")
    per_step = []
    for i, batch in enumerate(_batches()):
        state, logs, _ = task.train_step(state, batch)
        grads = {k: p.grad.clone() for k, p in state.model.named_parameters()}
        tracked = {int(v) for k, v in state.model.state_dict().items()
                   if k.endswith("num_batches_tracked")}
        assert tracked == {i + 1}, (remat, i, tracked)
        per_step.append((logs["train_loss"], grads))
    return per_step, state.model.state_dict()


@pytest.mark.parametrize("drop", list(DROPOUT))
@pytest.mark.parametrize("route", list(ROUTES))
def test_remat_rungs_are_bitwise_none(route, drop):
    base_steps, base_sd = _steps("none", route, drop)
    for remat in ("enc", "all"):
        steps, sd = _steps(remat, route, drop)
        for (loss, grads), (loss0, grads0) in zip(steps, base_steps):
            assert torch.equal(loss, loss0), remat
            bad = [k for k in grads0 if not torch.equal(grads[k], grads0[k])]
            assert not bad, (remat, bad)
        bad = [k for k in base_sd if not torch.equal(sd[k], base_sd[k])]
        assert not bad, (remat, bad)


def _counting(monkeypatch, module, name):
    calls = [0]
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls[0] += 1
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("route", list(ROUTES))
def test_remat_recomputes_and_keeps_less(route, monkeypatch):
    """Each rung runs its sections' convs again in the backward (kernel
    route: K5 at in_conv and down1, 4 convs, then the decoder's 2; plain
    route: 8 encoder, 12 core and 4 decoder convs at S=2), and the bytes
    the forward saves for the backward outside the sections fall rung by
    rung."""
    if route == "kernel":
        calls = _counting(monkeypatch, conv3x3_train, "conv3x3_fwd")
        want = {"none": 6, "enc": 10, "all": 12}
    else:
        calls = _counting(monkeypatch, blocks, "conv3x3_reflect")
        want = {"none": 24, "enc": 32, "all": 48}
    batch = _batches(1)[0]
    kept = {}
    for remat in ("none", "enc", "all"):
        task = MimoUnetTask(**SMALL, remat=remat, **ROUTES[route])
        state = task.init_state(2, "cpu")
        saved = [0]

        def pack(t):
            saved[0] += t.numel() * t.element_size()
            return t

        calls[0] = 0
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            task.train_step(state, batch)
        assert calls[0] == want[remat], (remat, calls[0])
        kept[remat] = saved[0]
    assert kept["none"] > kept["enc"] > kept["all"], kept


def test_remat_mode_is_checked():
    with pytest.raises(ValueError, match="remat"):
        MimoUNetConfig(**BASE, remat="encoder")


@pytest.mark.parametrize("remat", ["enc", "all"])
def test_remat_mc_step_matches_jax(remat):
    """tests/test_torch_dropout.py's f32 MC-recipe step (two equal images,
    key 6) with ``remat`` on both sides: the loss within 2e-4 and Adam's
    first moments within 1e-4 of the largest."""
    cfg, params, state = jax_weights()
    cfg = dataclasses.replace(cfg, **MC, remat=remat)
    hp = dict(in_channels=3, out_channels=2, num_subnetworks=2,
              filter_base_count=6, loss="laplace_nll", ct_kernels="off",
              remat=remat, **MC)
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
        m = opt.state[p]["exp_avg"].numpy()
        scale = float(np.max(np.abs(mu[k])))
        np.testing.assert_allclose(m, mu[k], atol=1e-4 * scale + 1e-12, rtol=0,
                                   err_msg=k)
