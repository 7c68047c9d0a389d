"""The port's training harness (CPU): task hparams, the data pipeline, the
capacity ladder, checkpoints, the trainer and its resume.

* Against the JAX package: ``hparams()`` key for key, the parameter count
  on transplanted weights, the batch order of ``iterate_index_batches``,
  ``iterate_batches`` and ``DataModule.train_batches``, the image grids of
  ``output_monitor_images``, and a checkpoint: the port trains a few
  steps, saves and loads, and the loaded ``state_dict`` carried through
  ``mimo_unet_tpu/interop.py`` gives the JAX ``val_step`` the port's
  ``val_step`` logs within docs/PARITY.md's 2e-4.
* Against the port itself: the ladder (an injected out-of-memory error at
  "none" leaves the state as it found it and the step runs at "enc", bit
  for bit a direct "enc" step; other errors propagate; out of memory at
  every rung raises), ``Trainer.fit`` (2 epochs at fbc 4, 32x32: ``last/``,
  ``best/``, ``hparams.json``, the TSV log), resume (1 epoch, then a resume
  to 2, bitwise a straight 2-epoch run in parameters, buffers, Adam's
  moments, the schedule, the loss buffer, ``step`` and both generators),
  the hparams-after-state commit order, the prefetcher, and what the
  trainer refuses.  The device cache's own tests are
  ``tests/test_torch_data.py``'s.
"""

import dataclasses
import json
import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimo_unet_tpu.data import core as jax_core
from mimo_unet_tpu.interop import torch_state_dict_to_pytree
from mimo_unet_tpu.models.mimo_unet import (
    MimoUNetConfig as JaxConfig,
    count_parameters as jax_count_parameters,
)
from mimo_unet_tpu.tasks.mimo import MimoUnetTask as JaxTask
from mimo_unet_tpu.visualization import output_monitor_images as jax_monitor_images

from mimo_unet_torch.data import core
from mimo_unet_torch.tasks.evidential import EvidentialUnetTask
from mimo_unet_torch.tasks.mimo import MimoUnetTask
from mimo_unet_torch.train import capacity, checkpoint, profiling
from mimo_unet_torch.train.trainer import Trainer
from mimo_unet_torch.visualization import output_monitor_images

from test_torch_slice import BASE, jax_weights, torch_model

SMALL = dict(in_channels=3, out_channels=2, num_subnetworks=2,
             filter_base_count=4)
HW = 32


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These steps are small: torch's intra-op threads cost more than they
    give, most of all beside other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(n, seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, (n, HW, HW, 3), dtype=np.uint8),
            "label": rng.integers(0, 256, (n, HW, HW, 1), dtype=np.uint8)}


class Synthetic(core.DataModule):
    """uint8 NYUv2-schema frames (``mimo_unet_tpu/data/nyuv2.py``'s
    ``host_dtype="uint8"`` arrays): 8 train and 4 val images."""

    batch_size = 2

    def setup(self):
        self.train, self.val = (core.ArrayDataset(_arrays(8, 0)),
                                core.ArrayDataset(_arrays(4, 1)))

    def train_dataset(self):
        return self.train

    def val_dataset(self):
        return self.val


def _torch_batches():
    """The first three train batches of ``Synthetic`` as tensors."""
    dm = Synthetic()
    dm.setup()
    return [{k: torch.from_numpy(v) for k, v in b.items()}
            for b in dm.train_batches(0, seed=1)][:3]


# ------------------------------------------------------------ vs the JAX package

def test_hparams_and_parameter_count_match_jax():
    kw = dict(SMALL, loss="gaussian_nll", decoder_dropout_rate=0.1,
              learning_rate=3e-4, remat="enc", compute_dtype="bfloat16")
    assert MimoUnetTask(**kw).hparams() == JaxTask(**kw).hparams()
    cfg, params, state = jax_weights()
    model = torch_model(BASE, params, state)
    task = MimoUnetTask(**BASE)
    st = dataclasses.replace(task.init_state(1, "cpu"), model=model)
    assert task.trainable_params(st) == jax_count_parameters(params) > 0


@pytest.mark.parametrize("n,bs,shuffle,drop_last,seed,epoch", [
    (10, 3, True, True, 42, 0), (10, 3, True, False, 42, 1),
    (7, 2, False, False, None, 0), (16, 4, True, True, 0, 5),
])
def test_batch_order_matches_jax(n, bs, shuffle, drop_last, seed, epoch):
    kw = dict(shuffle=shuffle, drop_last=drop_last, seed=seed, epoch=epoch)
    got = list(core.iterate_index_batches(n, bs, **kw))
    want = list(jax_core.iterate_index_batches(n, bs, **kw))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    data = {"x": np.arange(n * 2).reshape(n, 2), "y": np.arange(n)}
    for a, b in zip(core.iterate_batches(core.ArrayDataset(data), bs, **kw),
                    jax_core.iterate_batches(jax_core.ArrayDataset(data), bs, **kw)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_datamodule_train_batches_match_jax():
    class JaxSynthetic(jax_core.DataModule):
        batch_size = 2

        def setup(self):
            self.train = jax_core.ArrayDataset(_arrays(8, 0))

        def train_dataset(self):
            return self.train

    port, ref = Synthetic(), JaxSynthetic()
    port.setup()
    ref.setup()
    for epoch in range(3):
        got = list(port.train_batches(epoch, seed=7))
        want = list(ref.train_batches(epoch, seed=7))
        assert len(got) == len(want) == 4
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a["image"], b["image"])


def test_monitor_images_match_jax():
    rng = np.random.default_rng(2)
    outputs = {k: rng.uniform(0, 1, (3, 8, 8, 1)).astype(np.float32)
               for k in ("label", "preds", "err_map", "aleatoric_std_map",
                         "epistemic_std_map")}
    outputs["mask"] = (rng.uniform(0, 1, (3, 8, 8, 1)) > 0.3).astype(np.float32)
    for mode in ("depth", "sen12tp"):
        got, want = output_monitor_images(outputs, mode), jax_monitor_images(outputs, mode)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])


def test_checkpoint_roundtrip_val_step_matches_jax(tmp_path):
    """Three f32 plain-route steps, save, load: the loaded state equals the
    saved one bit for bit, and its weights through the JAX package's
    interop give the JAX ``val_step`` the port's logs within 2e-4."""
    task = MimoUnetTask(**SMALL, ct_kernels="off", decoder_dropout_rate=0.1)
    state = task.init_state(4, "cpu")
    for batch in _torch_batches():
        state, _, _ = task.train_step(state, batch)
    path = str(tmp_path / "ck")
    checkpoint.save_checkpoint(path, state, task.hparams())
    task2, loaded = checkpoint.load_checkpoint(path, 4, device="cpu")
    assert task2 == task and loaded.step == state.step == 3
    _assert_states_equal(loaded, state)

    val = {k: torch.from_numpy(v) for k, v in _arrays(2, 5).items()}
    logs, _ = task.val_step(loaded.model, val)
    sd = {k: v.numpy() for k, v in loaded.model.state_dict().items()}
    jcfg = JaxConfig(**{**SMALL, "decoder_dropout_rate": 0.1})
    params, mstate = torch_state_dict_to_pytree(sd, jcfg)
    jtask = JaxTask(**SMALL, decoder_dropout_rate=0.1)
    jlogs, _ = jax.jit(jtask.val_step)(
        params, mstate, {k: jnp.asarray(v) for k, v in _arrays(2, 5).items()})
    assert logs.keys() == jlogs.keys()
    for k in logs:
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]), rtol=2e-4,
                                   atol=2e-4, err_msg=k)


# ------------------------------------------------------------------ the port

def _state_tensors(state):
    """Every tensor and number a step writes in ``state``, by name."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    params = dict(state.model.named_parameters())
    names = {id(p): k for k, p in params.items()}
    for p, st in state.optimizer.state.items():
        for k, v in st.items():
            out[f"adam.{names[id(p)]}.{k}"] = v
    for k, p in params.items():
        out[f"grad.{k}"] = p.grad
    out["loss_buffer"] = state.loss_buffer.buffer
    out["generator"] = state.generator.get_state()
    if state.dropout_generator is not None:
        out["dropout_generator"] = state.dropout_generator.get_state()
    out["numbers"] = torch.tensor([state.step, state.loss_buffer.index,
                                   state.scheduler.last_epoch,
                                   state.optimizer.param_groups[0]["lr"]],
                                  dtype=torch.float64)
    return out


def _assert_states_equal(a, b, grads=False):
    ta, tb = _state_tensors(a), _state_tensors(b)
    if not grads:
        ta = {k: v for k, v in ta.items() if not k.startswith("grad.")}
        tb = {k: v for k, v in tb.items() if not k.startswith("grad.")}
    assert ta.keys() == tb.keys()
    bad = [k for k in ta if not ((ta[k] is None and tb[k] is None)
                                 or torch.equal(ta[k], tb[k]))]
    assert not bad, bad


def _oom():
    return torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                       "2.00 GiB")


LADDER_TASK = dict(SMALL, ct_kernels="force", compute_dtype="bfloat16",
                   decoder_dropout_rate=0.1)


@pytest.mark.parametrize("where", ["forward", "optimizer"])
def test_ladder_recovers_from_oom_bitwise(where, monkeypatch):
    """Out of memory at "none" (after the forward: BatchNorm buffers and
    both generators moved; or after Adam's update: parameters and moments
    moved too) leaves the state as it was; the step then runs at "enc",
    bit for bit a direct "enc" step from the same state, and so does the
    next step through the returned step function."""
    task = MimoUnetTask(**LADDER_TASK)
    batches = _torch_batches()
    state = task.init_state(4, "cpu")
    state, _, _ = task.train_step(state, batches[0])  # moments, buffer filled
    before = {k: v.clone() for k, v in _state_tensors(state).items()
              if v is not None}

    if where == "forward":
        forward = type(state.model).forward

        def failing(model, *args, **kwargs):
            out = forward(model, *args, **kwargs)
            if model.config.remat == "none":
                raise _oom()
            return out

        monkeypatch.setattr(type(state.model), "forward", failing)
    else:
        step = state.scheduler.step

        def failing():
            step()
            if state.model.config.remat == "none":
                raise _oom()

        monkeypatch.setattr(state.scheduler, "step", failing)

    snapshots = []
    restore = capacity._restore
    monkeypatch.setattr(capacity, "_restore", lambda s, snap: (
        restore(s, snap), snapshots.append(
            {k: v.clone() for k, v in _state_tensors(s).items() if v is not None})))
    step_fn, used = capacity.make_train_step(task, state, batches[1],
                                             verbose=False)
    assert used.remat == "enc" and state.model.config.remat == "enc"
    assert len(snapshots) == 1  # restored once, after the "none" attempt
    assert snapshots[0].keys() == before.keys()
    assert all(torch.equal(snapshots[0][k], before[k]) for k in before)

    direct_task = dataclasses.replace(task, remat="enc")
    direct = direct_task.init_state(4, "cpu")
    direct, _, _ = direct_task.train_step(direct, batches[0])
    direct, _, _ = direct_task.train_step(direct, batches[1])
    _assert_states_equal(state, direct, grads=True)
    state, _, _ = step_fn(state, batches[2])
    direct, _, _ = direct_task.train_step(direct, batches[2])
    _assert_states_equal(state, direct, grads=True)


def test_ladder_other_errors_propagate_and_last_oom_raises(monkeypatch):
    task = MimoUnetTask(**LADDER_TASK)
    batch = _torch_batches()[0]
    state = task.init_state(4, "cpu")
    forward = type(state.model).forward

    def bad_shape(model, *args, **kwargs):
        raise RuntimeError("shape mismatch")

    monkeypatch.setattr(type(state.model), "forward", bad_shape)
    with pytest.raises(RuntimeError, match="shape mismatch"):
        capacity.make_train_step(task, state, batch, verbose=False)

    before = {k: v.clone() for k, v in _state_tensors(state).items()
              if v is not None}
    seen = []

    def always_oom(model, *args, **kwargs):
        forward(model, *args, **kwargs)
        seen.append(model.config.remat)
        raise _oom()

    monkeypatch.setattr(type(state.model), "forward", always_oom)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        capacity.make_train_step(task, state, batch, verbose=False)
    assert seen == ["none", "enc", "all"]
    assert state.model.config.remat == "none"
    after = _state_tensors(state)
    assert all(torch.equal(after[k], before[k]) for k in before)


def test_is_cuda_oom():
    assert capacity.is_cuda_oom(_oom())
    assert capacity.is_cuda_oom(RuntimeError("CUDA out of memory. Tried ..."))
    assert not capacity.is_cuda_oom(RuntimeError("CUDA error: an illegal "
                                                 "memory access"))
    assert not capacity.is_cuda_oom(ValueError("out of range"))


def _trainer(tmp_path, name, epochs, task=None, **kw):
    task = task or MimoUnetTask(**SMALL, input_repetition_probability=0.5,
                                decoder_dropout_rate=0.1)
    return Trainer(task, Synthetic(), max_epochs=epochs,
                   checkpoint_path=str(tmp_path / name), log_every_n_steps=3,
                   device="cpu", **kw)


def test_fit_writes_checkpoints_and_logs(tmp_path):
    trainer = _trainer(tmp_path, "run", 2)
    state = trainer.fit()
    root = tmp_path / "run"
    assert state.step == 8 and len(trainer.history) == 2
    for d in ("last", "best"):
        assert (root / d / "state" / "state.pt").is_file()
        assert not (root / d / "hparams.json.pending").exists()
    hp = json.loads((root / "last" / "hparams.json").read_text())
    assert hp == trainer.task.hparams()
    best = json.loads((root / "best" / "hparams.json").read_text())["best"]
    assert best["val_loss"] == min(h["val_loss"] for h in trainer.history)
    rows = [json.loads(line) for line in (root / "metrics.tsv").read_text().splitlines()]
    # scalars of steps 0, 3 and 6, then one row an epoch
    assert [r["step"] for r in rows if "train_loss" in r] == [0, 3, 6]
    epochs = [r for r in rows if "epoch" in r]
    assert [r["epoch"] for r in epochs] == [0, 1]
    assert all(np.isfinite(r["val_loss"]) for r in epochs)
    assert any(f.startswith("train_pred_step") for f in os.listdir(root / "images"))


def test_resume_is_bitwise_a_straight_run(tmp_path):
    straight = _trainer(tmp_path, "straight", 2).fit()
    _trainer(tmp_path, "resumed", 1).fit()
    resumed = _trainer(tmp_path, "resumed", 2).fit(resume=True)
    assert resumed.step == straight.step == 8
    _assert_states_equal(resumed, straight)


def test_failed_state_write_leaves_no_hparams(tmp_path, monkeypatch):
    task = MimoUnetTask(**SMALL)
    state = task.init_state(4, "cpu")

    def fail(*_, **__):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", fail)
    with pytest.raises(OSError, match="disk full"):
        checkpoint.save_checkpoint(str(tmp_path / "sync"), state, task.hparams())
    assert not (tmp_path / "sync" / "hparams.json").exists()
    manager = checkpoint.CheckpointManager(str(tmp_path / "async"), task.hparams())
    manager.save_last(state)
    with pytest.raises(OSError, match="disk full"):
        manager.wait_until_finished()
    assert not (tmp_path / "async" / "last" / "hparams.json").exists()
    assert not manager.has_last()


def test_pending_hparams_read_when_final_missing(tmp_path):
    path = tmp_path / "ck"
    path.mkdir()
    (path / "hparams.json.pending").write_text(json.dumps({"task": "mimo_unet", "seed": 3}))
    assert checkpoint.load_hparams(str(path)) == {"task": "mimo_unet", "seed": 3}
    (path / "hparams.json").write_text(json.dumps({"task": "mimo_unet", "seed": 4}))
    assert checkpoint.load_hparams(str(path))["seed"] == 4


def test_worse_val_loss_after_resume_keeps_best(tmp_path):
    task = MimoUnetTask(**SMALL)
    state = task.init_state(4, "cpu")
    manager = checkpoint.CheckpointManager(str(tmp_path), task.hparams())
    assert manager.maybe_save_best(state, 0.5, 0, 4)
    manager.wait_until_finished()
    best = tmp_path / "best"
    written = ((best / "hparams.json").read_bytes(),
               (best / "state" / "state.pt").read_bytes())
    resumed = checkpoint.CheckpointManager(str(tmp_path), task.hparams())
    assert resumed.restore_best_tracking() == 0.5
    assert not resumed.maybe_save_best(state, 0.9, 1, 8)
    resumed.wait_until_finished()
    assert ((best / "hparams.json").read_bytes(),
            (best / "state" / "state.pt").read_bytes()) == written
    assert resumed.maybe_save_best(state, 0.4, 2, 12)


def _prefetchers():
    return [t for t in threading.enumerate() if t.name == "prefetch_to_device"]


def test_prefetch_on_cpu():
    """Order and completeness under frequent thread switches (more batches
    than the queue holds), the producer's error raised in the consumer,
    the producer gone once the consumer stops early, chunk > 1 refused."""
    batches = [{"image": np.full((2, 3), i), "mask": None} for i in range(200)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = list(core.prefetch_to_device(iter(batches), device="cpu"))
    finally:
        sys.setswitchinterval(interval)
    assert [int(b["image"][0, 0]) for b in got] == list(range(200))
    assert all(set(b) == {"image"} and isinstance(b["image"], torch.Tensor)
               for b in got)
    it = core.prefetch_to_device(iter(batches), device="cpu")
    assert int(next(it)["image"][0, 0]) == 0
    it.close()
    assert not _prefetchers()

    def broken():
        yield batches[0]
        raise OSError("h5 read failed")

    it = core.prefetch_to_device(broken(), device="cpu")
    next(it)
    with pytest.raises(OSError, match="h5 read failed"):
        next(it)
    with pytest.raises(ValueError, match="chunk"):
        next(core.prefetch_to_device(iter(batches), device="cpu", chunk=4))


def test_refusals_name_the_roadmap(tmp_path):
    """The trainer and the device cache refuse what is not ported (A.7),
    naming it, and take what is (A.3: ``device_cache``); what A.4 has
    ported loads: an evidential checkpoint gives an EvidentialUnetTask,
    and a reference Lightning .ckpt its task and weights."""
    task = MimoUnetTask(**SMALL)
    for kw, item in ((dict(num_devices=2), "A.7"), (dict(mesh=object()), "A.7")):
        with pytest.raises(NotImplementedError, match=item):
            _trainer(tmp_path, "x", 1, task, **kw)
    with pytest.raises(NotImplementedError, match="A.7"):
        core.DeviceDataset(core.ArrayDataset(_arrays(2, 0)), device="cpu", mesh=object())
    assert _trainer(tmp_path, "x", 1, task, device_cache=True).device_cache
    ev = EvidentialUnetTask(in_channels=3, filter_base_count=4)
    checkpoint.save_checkpoint(str(tmp_path / "ev"), ev.init_state(1, "cpu"), ev.hparams())
    assert json.loads((tmp_path / "ev" / "hparams.json").read_text())["task"] == "evidential_unet"
    got, _ = checkpoint.load_checkpoint(str(tmp_path / "ev"), device="cpu")
    assert isinstance(got, EvidentialUnetTask) and got == ev
    model = task.build_model("cpu")
    torch.save({"state_dict": {f"model.{k}": v for k, v in model.state_dict().items()},
                "hyper_parameters": dataclasses.asdict(task)}, tmp_path / "model.ckpt")
    got, state = checkpoint.load_checkpoint(str(tmp_path / "model.ckpt"), device="cpu")
    assert got == task
    for k, v in model.state_dict().items():
        assert torch.equal(state.model.state_dict()[k], v), k


def test_profiling_on_cpu(tmp_path):
    x, w = torch.randn(1, 4, 8, 8), torch.randn(6, 4, 3, 3)
    flops = profiling.cost_analysis(torch.nn.functional.conv2d, x, w)["flops"]
    assert flops == 2 * 6 * 4 * 9 * 6 * 6  # a valid 3x3 conv, 6x6 outputs
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.nn.functional.conv2d(x, w)
    assert (tmp_path / "tr" / "trace.json").is_file() and prof.key_averages()
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling.timed_per_exec(torch.nn.functional.conv2d, x, w)
