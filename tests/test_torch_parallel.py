"""The port's data parallelism (``mimo_unet_torch/parallel``) on the CPU.

Every two-rank check shares one spawn of 2 gloo CPU ranks
(``parallel.launch.spawn``, a file store in the test's directory, joined
within 180 s; a rank that fails or hangs fails the tests, never the
suite).  The ranks run ``tests/torch_parallel_ranks.py``; this process
builds the references meanwhile.  The ranks' halves of every batch come
from different distributions, so a BatchNorm site left rank-local shows.

* Against the JAX functions, bitwise: ``pad_batch_to_divisible``,
  ``host_local_batch_slice`` and its error, ``iterate_sharded_index_batches``
  and ``DeviceDataset(mesh=)``'s shard membership and rows (the JAX class on
  ``make_mesh(2)`` of the 8 CPU devices).
* Against the JAX package's step on ``make_mesh(2)``: the port's 2-rank f32
  plain-route step (32x256, fbc 6, global B=4, the JAX-transplanted
  weights; ``input_repetition_probability=1.0``, where the step does not
  depend on the permutation each package draws): loss and logs, the
  BatchNorm running statistics and the loss buffer at docs/PARITY.md's 2e-4
  forward bound; every gradient leaf within a fixed ``REORDER_TOL`` (5e-3)
  of its largest magnitude over the 1e-4 gradient bound, and at cosine
  >= 0.9999; the new parameters.  At B > 1 an f32 step of these weights
  moves its gradients by up to ~4e-3 of a leaf's scale under a mere
  reordering of the rows (measured: the single-process port against the
  JAX step, and against itself with the rows permuted), which is why the
  single-process parity test runs at B=1.  The single-process port is
  held to that same fixed bound, and the ranks' step to the
  single-process port's at 1e-4 a leaf.
* Against the port's own single-process step on the global batch (p=0.5,
  2 batch repetitions, 2 steps): each rank's transformed rows bitwise its
  slice of the single-process rows; the first step's logs, gradients
  (1e-4 abs), running statistics and loss buffer at f32 tolerance; the
  second step's logs (after one Adam step the noise-level gradients'
  signs have moved the weights by up to 2 lr); parameters and buffers
  bitwise equal across the ranks after each step.
* The kernel route (``ct_kernels="force"``, plain twins here, bf16): the
  forward makes one ``all_reduce_sum`` a BatchNorm site (6 kernel sites,
  12 core sites) and the backward one more each; the step holds the
  single-process step (loss, running statistics, and gradients by cosine
  to the f32 plain-route gradients no worse than the single-process bf16
  step's, tests/test_ct_mesh.py's hold), and the step with one kernel
  site's or one core site's all-reduce skipped does not.
* The evidential task's step; the capacity ladder with an out-of-memory
  error on one rank only (both ranks take "enc"); the kernel build on a
  fresh tree (stubbed nvcc) runs once, on rank 0.
* ``Trainer.fit(num_devices=2)``: val_loss of 2 host-fed epochs against the
  single-process fit; only rank 0 writes; ``last/`` loads bitwise; 1 epoch
  + a resume to 2 (with dropout) bitwise 2 straight epochs on each rank;
  1 epoch with the sharded device cache.
* The CLI: ``train_ndvi --num_devices 2 --device cpu`` starts two ranks and
  trains an epoch on synthetic SEN12TP tiles.

Torch runs on one thread here and in the ranks.  The file takes about
60 s alone.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimo_unet_tpu.data import core as jax_core
from mimo_unet_tpu.loss_buffer import LossBufferState as JaxLossBuffer
from mimo_unet_tpu.parallel import mesh as jax_mesh
from mimo_unet_tpu.parallel import multihost as jax_multihost
from mimo_unet_tpu.tasks.mimo import MimoUnetTask as JaxTask, TrainState as JaxState

from mimo_unet_torch.data import core
from mimo_unet_torch.interop import jax_pytree_to_state_dict
from mimo_unet_torch.parallel import launch, mesh, multihost
from mimo_unet_torch.tasks.evidential import EvidentialUnetTask
from mimo_unet_torch.tasks.mimo import MimoUnetTask
from mimo_unet_torch.train.trainer import Trainer

import torch_parallel_ranks as R
from make_fixtures import make_sen12tp_tiles
from test_torch_slice import jax_weights, torch_model

JOIN_S = 180
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_HP = dict(R.TASK, ct_kernels="off", weight_decay=1e-4, input_repetition_probability=1.0,
              scheduler_step_size=1, loss_buffer_temperature=0.5)
SELF_HP = dict(R.TASK, ct_kernels="off", weight_decay=1e-4, input_repetition_probability=0.5,
               batch_repetitions=2)
KERNEL_HP = dict(R.TASK, ct_kernels="force", compute_dtype="bfloat16",
                 input_repetition_probability=1.0)
EV_HP = dict(in_channels=3, filter_base_count=6, ct_kernels="off")
LR = 1e-3
# the train route's BatchNorm sites: in_conv, down1 and up4 (two each) on
# the kernels, the core's six DoubleConvs (two each) in the plain modules
KERNEL_SITES, CORE_SITES = 6, 12
# how far an f32 step's gradients move, as a share of a leaf's largest
# magnitude, when only the order of the B=4 rows changes (the port against
# itself with the rows permuted, and against the JAX step: up to ~4e-3)
REORDER_TOL = 5e-3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_inputs():
    cfg, params, state = jax_weights()
    task = MimoUnetTask(**JAX_HP)
    sd = torch_model(dataclasses.asdict(task.model_config), params, state).state_dict()
    lb = np.random.default_rng(12).uniform(0.5, 2.0, (10, 2)).astype(np.float32)
    return cfg, params, state, {"jax_hp": JAX_HP, "jax_sd": sd, "jax_lb": (lb, 3),
                                "jax_batch": R.halves_batch(1)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' results (rank 0's, rank 1's), the JAX mesh step and the
    single-process references, built while the ranks run."""
    out = str(tmp_path_factory.mktemp("ranks"))
    cfg, params, state, inputs = _jax_inputs()
    inputs.update(self_hp=SELF_HP, kernel_hp=KERNEL_HP, ev_hp=EV_HP)
    failure = []

    def run():
        try:
            launch.spawn(R.run_ranks, 2, (out, inputs), device="cpu", timeout=JOIN_S)
        except BaseException as e:  # noqa: BLE001 (raised in the tests)
            failure.append(e)

    thread = threading.Thread(target=run)
    thread.start()
    refs = {"jax": _jax_mesh_step(cfg, params, state, inputs),
            "jax_single_port": _port_jax_step(inputs), "self": _self_steps(),
            "kernel": _kernel_step(KERNEL_HP),
            "kernel_f32": _kernel_step(dict(KERNEL_HP, ct_kernels="off", compute_dtype=None)),
            "evidential": _evidential_step(),
            "fit": _single_fit(str(tmp_path_factory.mktemp("single")))}
    thread.join()
    if failure:
        raise failure[0]
    got = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False) for r in (0, 1)]
    with open(os.path.join(out, "builds.txt")) as f:
        builds = f.read().splitlines()
    return got, refs, builds


# ------------------------------------------------------------ references

def _jax_mesh_step(cfg, params, state, inputs):
    """The JAX task's step on a 2-device mesh, its state and batch placed
    as the JAX trainer places them."""
    jtask = JaxTask(**JAX_HP)
    tx = jtask.make_optimizer(1)
    lb, index = inputs["jax_lb"]
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=params, model_state=state,
                      opt_state=tx.init(params),
                      loss_buffer=JaxLossBuffer(buffer=jnp.asarray(lb),
                                                index=jnp.asarray(index, jnp.int32)))
    m = jax_mesh.make_mesh(2)
    repl, data = jax_mesh.replicated_sharding(m), jax_mesh.batch_sharding(m)
    with jax_mesh.ct_mesh_scope(m):
        jnew, jlogs, _ = jax.jit(functools.partial(jtask.train_step, tx, with_outputs=False),
                                 in_shardings=(repl, data, repl))(
            jstate, {k: jnp.asarray(v) for k, v in inputs["jax_batch"].items()},
            jax.random.key(0))
    mu = next(s.mu for s in jnew.opt_state if hasattr(s, "mu"))

    def named(tree):
        sd = jax_pytree_to_state_dict(tree, jnew.model_state, cfg)
        return {k: v.numpy() for k, v in sd.items()}

    stats = ("running_mean", "running_var", "num_batches_tracked")
    mu, new = named(mu), named(jnew.params)
    before = {k: v.numpy() for k, v in inputs["jax_sd"].items()}
    wd = JAX_HP["weight_decay"]
    return {"logs": {k: float(v) for k, v in jlogs.items()},
            "mu": {k: v for k, v in mu.items() if not k.endswith(stats)},
            # Adam's first moment after one step is 0.1 * (g + wd * p)
            "grads": {k: v / 0.1 - wd * before[k] for k, v in mu.items()
                      if not k.endswith(stats)},
            "params": {k: v for k, v in new.items() if not k.endswith(stats)},
            "stats": {k: v for k, v in new.items() if k.endswith(stats[:2])},
            "loss_buffer": np.asarray(jnew.loss_buffer.buffer),
            "lb_index": int(jnew.loss_buffer.index)}


def _port_jax_step(inputs):
    """The port's single-process step of the JAX-transplanted weights."""
    task = MimoUnetTask(**JAX_HP)
    state = R.fresh_state(task, inputs["jax_sd"], loss_buffer=inputs["jax_lb"])
    state, logs, _ = task.train_step(state, R.torch_batch(inputs["jax_batch"]))
    return R.step_record(state, logs)


def _self_steps(steps=2):
    task = MimoUnetTask(**SELF_HP)
    state = R.fresh_state(task)
    out = []
    for i in range(steps):
        rows = []
        with R.recorded_rows(rows):
            state, logs, _ = task.train_step(state, R.torch_batch(R.halves_batch(10 + i)))
        out.append(dict(R.step_record(state, logs), rows=rows[0]))
    return out


def _kernel_step(hp):
    task = MimoUnetTask(**hp)
    state = R.fresh_state(task, gen_seed=R.KERNEL_GEN_SEED)
    rows = []
    with R.recorded_rows(rows):
        state, logs, _ = task.train_step(state, R.torch_batch(R.halves_batch(20, mask=False)))
    return dict(R.step_record(state, logs), rows=rows[0])


def _evidential_step():
    task = EvidentialUnetTask(**EV_HP)
    state = R.fresh_state(task)
    state, logs, _ = task.train_step(state, R.torch_batch(R.halves_batch(30, mask=False)))
    return R.step_record(state, logs)


def _single_fit(root):
    trainer = Trainer(MimoUnetTask(**R.FIT_TASK), R.make_datamodule(), max_epochs=2,
                      checkpoint_path=root, log_every_n_steps=1, log_images=False,
                      device="cpu")
    trainer.fit()
    return trainer.history


# ----------------------------------------------------------------- holds

def _close(got, want, what, rtol, atol_scale):
    """Every leaf of ``want`` (name -> tensor or array) within ``rtol`` and
    ``atol_scale`` times its largest magnitude."""
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        g = np.asarray(got[k], np.float64)
        scale = float(np.max(np.abs(w))) if w.size else 0.0
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol_scale * scale + 1e-12,
                                   err_msg=f"{what} {k}")


def _params_after_adam(got, want, mu, what, grad_tol=None):
    """Adam's first step moves each weight by about lr * sign(g): held tight
    where the gradient stands clear of rounding, of Adam's epsilon and of
    ``grad_tol`` (name -> the gradient difference allowed, which may flip
    a smaller gradient's sign), within the step's size elsewhere
    (tests/test_torch_train.py's hold; ``mu`` is Adam's first moment,
    0.1 * the gradient)."""
    for k, w in want.items():
        g, w, m = (np.asarray(t, np.float64) for t in (got[k], w, mu[k]))
        scale = float(np.max(np.abs(m)))
        floor = 0.1 * grad_tol[k] if grad_tol else 0.0
        strong = np.abs(m) > max(1e-3 * scale, 0.1 * 1e-5, floor)
        np.testing.assert_allclose(g[strong], w[strong], atol=1e-6, rtol=0,
                                   err_msg=f"{what} {k}")
        assert np.all(np.abs(g - w) <= 2 * LR + 1e-6), f"{what} {k}"


def _same_across_ranks(a, b, what):
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    assert not bad, f"{what}: ranks differ at {bad[:5]}"


def _running(buffers):
    return {k: v for k, v in buffers.items() if not k.endswith("num_batches_tracked")}


def _hold_logs(got, want, what, tol=2e-4):
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=tol, atol=tol, err_msg=f"{what} log {k}")


def _hold_step(got, want, what):
    """A rank's f32 step against the single-process one: logs, gradients
    (docs/PARITY.md's 1e-4 abs), running statistics, the loss buffer;
    parameters after Adam."""
    _hold_logs(got["logs"], want["logs"], what)
    for k, w in want["grads"].items():
        np.testing.assert_allclose(got["grads"][k], w, rtol=0, atol=1e-4,
                                   err_msg=f"{what} gradient {k}")
    _close(_running(got["buffers"]), _running(want["buffers"]), f"{what} running stat",
           1e-4, 1e-5)
    np.testing.assert_allclose(got["loss_buffer"], want["loss_buffer"], atol=2e-4)
    assert got["lb_index"] == want["lb_index"]
    _params_after_adam(got["params"], want["params"], want["exp_avg"], what,
                       {k: 1e-4 for k in want["grads"]})


def _cosines(ref, other):
    """Per-leaf cosine of ``other`` to ``ref``, noise-level leaves skipped
    (tests/test_torch_train.py's threshold)."""
    out = {}
    for k, a in ref.items():
        a, b = np.asarray(a, np.float64).ravel(), np.asarray(other[k], np.float64).ravel()
        if float(np.max(np.abs(a))) < 5e-3:
            continue
        out[k] = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))
    return np.array(list(out.values()))


# ------------------------------------------------- JAX helpers, bitwise

@pytest.mark.parametrize("b,n", [(5, 4), (8, 4), (3, 2), (7, 1), (1, 2)])
def test_pad_batch_to_divisible_matches_jax(b, n):
    rng = np.random.default_rng(b * 10 + n)
    batch = {"x": rng.standard_normal((b, 3)).astype(np.float32),
             "y": rng.integers(0, 9, (b, 2, 2), dtype=np.uint8)}
    got, real = mesh.pad_batch_to_divisible(batch, n)
    want, jreal = jax_mesh.pad_batch_to_divisible(batch, n)
    assert real == jreal == b and got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("world,rank,batch", [(1, 0, 6), (3, 1, 6), (4, 3, 8), (3, 2, 7)])
def test_host_local_batch_slice_matches_jax(world, rank, batch, monkeypatch):
    import torch.distributed as dist

    monkeypatch.setattr(jax, "process_count", lambda: world)
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: world)
    monkeypatch.setattr(dist, "get_rank", lambda *a, **k: rank)
    if batch % world:
        with pytest.raises(ValueError) as want:
            jax_multihost.host_local_batch_slice(batch)
        with pytest.raises(ValueError, match=str(want.value)):
            multihost.host_local_batch_slice(batch)
    else:
        assert (multihost.host_local_batch_slice(batch)
                == jax_multihost.host_local_batch_slice(batch))


@pytest.mark.parametrize("n,shards,b,seed,epoch,shuffle", [
    (10, 2, 4, 0, 0, True), (11, 2, 4, 3, 2, True), (16, 4, 8, 1, 1, True),
    (9, 3, 3, 7, 5, True), (12, 2, 6, 0, 0, False), (5, 2, 2, None, 0, False)])
def test_iterate_sharded_index_batches_matches_jax(n, shards, b, seed, epoch, shuffle):
    kw = dict(shuffle=shuffle, seed=seed, epoch=epoch)
    got = list(core.iterate_sharded_index_batches(n, shards, b, **kw))
    want = list(jax_core.iterate_sharded_index_batches(n, shards, b, **kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n,seed", [(8, 0), (7, 3), (5, 11)])
def test_device_dataset_shards_match_jax(n, seed):
    """Each rank's pinned rows are the JAX class's shard of that device on
    make_mesh(2), bitwise, and the gathers of the shard-local batches agree."""
    arrays = R.fit_arrays(n, seed)
    want = jax_core.DeviceDataset(jax_core.ArrayDataset(arrays), mesh=jax_mesh.make_mesh(2),
                                  seed=seed)
    shards = {int(s.index[0].start or 0) // want.n_local: np.asarray(s.data)
              for s in want.data["image"].addressable_shards}
    idx = next(jax_core.iterate_sharded_index_batches(n, 2, 4, shuffle=True, seed=seed))
    gathered = np.asarray(jax.jit(want.gather)(jnp.asarray(idx))["image"])
    for r in (0, 1):
        ds = core.DeviceDataset(core.ArrayDataset(arrays), device="cpu",
                                mesh=mesh.Mesh(None, r, 2, torch.device("cpu")), seed=seed)
        assert (ds.n_shards, ds.n_local) == (want.n_shards, want.n_local)
        np.testing.assert_array_equal(ds.wrapped, want.wrapped)
        np.testing.assert_array_equal(ds.data["image"].numpy(), shards[r])
        np.testing.assert_array_equal(ds.gather(idx)["image"].numpy(),
                                      gathered[r * 2:(r + 1) * 2])


def test_mesh_without_a_process_group():
    """One process: a mesh of one (no collective is ever called); more
    ranks raise, naming how to start them; Trainer(num_devices=2) too."""
    one = mesh.make_mesh(device="cpu")
    assert (one.size, one.rank, one.group, one.device) == (1, 0, None, torch.device("cpu"))
    assert one.rows(6) == (0, 6) and one.shape == {mesh.DATA_AXIS: 1}
    with pytest.raises(ValueError, match="torchrun"):
        mesh.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="torchrun"):
        Trainer(MimoUnetTask(**R.FIT_TASK), R.make_datamodule(), max_epochs=1,
                checkpoint_path="unused", num_devices=2, device="cpu")
    second = mesh.Mesh(None, 1, 2, torch.device("cpu"))
    assert second.rows(6) == (3, 6)
    batch = R.halves_batch(2, b=6, hw=(2, 2))
    got = mesh.shard_batch(dict(batch, mask=None), second)
    assert got.keys() == {"image", "label"}
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), batch[k][3:6])
    with pytest.raises(ValueError, match="divisible"):
        mesh.Mesh(None, 1, 2, torch.device("cpu")).rows(5)


def test_spawn_fails_when_a_rank_fails():
    with pytest.raises(Exception, match="rank 1 fails"):
        launch.spawn(R.failing_rank, 2, (), device="cpu", timeout=60)


# ------------------------------------------------------- the two ranks

def test_ranks_and_the_stubbed_build(ranks):
    got, _, builds = ranks
    assert [g["rank"] for g in got] == [0, 1] and all(g["size"] == 2 for g in got)
    assert builds == ["rank 0"]  # one build, by rank 0; rank 1 loaded it
    assert got[0]["build"] == got[1]["build"]


def test_step_matches_jax_mesh_step(ranks):
    got, refs, _ = ranks
    want = refs["jax"]
    for r in (0, 1):
        g = got[r]["jax_step"]
        _hold_logs(g["logs"], want["logs"], "JAX")
        base = refs["jax_single_port"]["grads"]
        allowed = {}
        for k, w in want["grads"].items():
            # a fixed bound, not a measured one: the f32 reorder spread of
            # these weights at B=4 (REORDER_TOL of the leaf's largest
            # magnitude) over docs/PARITY.md's 1e-4, which the
            # single-process port and the ranks' step both keep to
            allowed[k] = REORDER_TOL * float(np.max(np.abs(w))) + 1e-4
            np.testing.assert_allclose(base[k].numpy(), w, rtol=0, atol=allowed[k],
                                       err_msg=f"single-process gradient {k}")
            np.testing.assert_allclose(g["grads"][k], w, rtol=0, atol=allowed[k],
                                       err_msg=f"gradient {k}")
            # and what the ranks add, directly: PARITY's 1e-4 a leaf
            np.testing.assert_allclose(g["grads"][k], base[k].numpy(), rtol=0,
                                       atol=1e-4, err_msg=f"gradient {k} vs one process")
        assert _cosines(want["grads"], g["grads"]).min() >= 0.9999
        _params_after_adam(g["params"], want["params"], want["mu"], "parameter", allowed)
        for k, v in want["stats"].items():
            np.testing.assert_allclose(g["buffers"][k], v, atol=2e-4, rtol=0, err_msg=k)
        np.testing.assert_allclose(g["loss_buffer"], want["loss_buffer"], atol=2e-4)
        assert g["lb_index"] == want["lb_index"] == 4
    _same_across_ranks(got[0]["jax_step"]["params"], got[1]["jax_step"]["params"],
                       "parameters")


def test_step_matches_single_process(ranks):
    got, refs, _ = ranks
    for i, want in enumerate(refs["self"]):
        for r in (0, 1):
            g = got[r]["self_plain"][i]
            rows = slice(r * 4, (r + 1) * 4)  # B * reps / D of the transformed batch
            for k in ("image", "label", "mask"):
                assert torch.equal(g["rows"][k], want["rows"][k][rows]), (i, r, k)
            # a rank's rows are its own: no view keeps the global batch alive
            # through the forward and backward (the capacity probe, which
            # sees only this rank's rows, then prices what the step holds)
            assert g["rows"]["own"] == {"image": True, "label": True, "mask": True}, (i, r)
            if i == 0:
                _hold_step(g, want, f"step {i} rank {r}")
            else:
                _hold_logs(g["logs"], want["logs"], f"step {i} rank {r}", 2e-3)
        _same_across_ranks(got[0]["self_plain"][i]["params"],
                           got[1]["self_plain"][i]["params"], f"step {i} parameters")
        _same_across_ranks(got[0]["self_plain"][i]["buffers"],
                           got[1]["self_plain"][i]["buffers"], f"step {i} buffers")


def _hold_kernel(got, want, f32, what):
    """A bf16 kernel-route step against the single-process one: the loss
    within 1e-2, the running statistics within 5e-3 + 1e-2 relative, and
    the gradients as close to the f32 plain-route gradients as the
    single-process step's are, up to tests/test_ct_mesh.py's slack (0.15
    on the minimum cosine, 0.05 on the mean)."""
    np.testing.assert_allclose(got["logs"]["train_loss"], want["logs"]["train_loss"],
                               rtol=1e-2, err_msg=f"{what} loss")
    for k, w in _running(want["buffers"]).items():
        np.testing.assert_allclose(got["buffers"][k], w, rtol=1e-2, atol=5e-3,
                                   err_msg=f"{what} running stat {k}")
    single, ranks = _cosines(f32["grads"], want["grads"]), _cosines(f32["grads"], got["grads"])
    assert ranks.min() > single.min() - 0.15, (what, ranks.min(), single.min())
    assert ranks.mean() > single.mean() - 0.05, (what, ranks.mean(), single.mean())


def test_kernel_route_all_reduces_every_site(ranks):
    got, refs, _ = ranks
    want = refs["kernel"]
    lows = []
    for r in (0, 1):
        k = got[r]["kernel"]
        # each rank's rows after the transform are one half of the batch
        # (the halves swap ranks here), so a rank-local statistic would be
        # far from the global one
        image = k["ok"]["rows"]["image"]
        lows.append(bool(image.max() < 80 / 255))
        assert lows[-1] or bool(image.min() >= 150 / 255)
        assert torch.equal(image, want["rows"]["image"][r * 2:(r + 1) * 2])
        counts = k["counts"]
        assert counts["stats"][0] == counts["stats_grad"][0] == KERNEL_SITES + CORE_SITES
        assert counts["rows"][0] == 2 and counts["grads"][0] == 1
        _hold_kernel(k["ok"], want, refs["kernel_f32"], f"kernel route rank {r}")
        for variant in ("skip_kernel", "skip_core"):
            with pytest.raises(AssertionError):
                _hold_kernel(k[variant], want, refs["kernel_f32"], f"{variant} rank {r}")
    assert sorted(lows) == [False, True]
    _same_across_ranks(got[0]["kernel"]["ok"]["params"], got[1]["kernel"]["ok"]["params"],
                       "kernel route parameters")


def test_evidential_step_matches_single_process(ranks):
    got, refs, _ = ranks
    for r in (0, 1):
        _hold_step(got[r]["evidential"], refs["evidential"], f"evidential rank {r}")
    _same_across_ranks(got[0]["evidential"]["params"], got[1]["evidential"]["params"],
                       "evidential parameters")


def test_ladder_agrees_on_a_rung(ranks):
    got, _, _ = ranks
    assert [g["ladder"]["rung"] for g in got] == ["enc", "enc"]
    _same_across_ranks(got[0]["ladder"]["params"], got[1]["ladder"]["params"],
                       "ladder parameters")


def test_fit_on_two_ranks(ranks):
    got, refs, _ = ranks
    for r in (0, 1):
        f = got[r]["fits"]
        assert f["mesh_size"] == 2
        np.testing.assert_allclose([h["val_loss"] for h in f["history"]],
                                   [h["val_loss"] for h in refs["fit"]], rtol=1e-4)
        assert all(f["resume"].values()), [k for k, v in f["resume"].items() if not v]
        assert f["last_equal"]
        assert f["cached_fed"] == {"cached": R.FIT_TRAIN // R.FIT_B}
        assert np.isfinite([h["val_loss"] for h in f["cached_history"]]).all()
    assert got[0]["fits"]["writes"] > 0 and got[1]["fits"]["writes"] == 0
    for run in ("host", "cached"):
        _same_across_ranks(got[0]["fits"][run], got[1]["fits"][run], f"fit {run}")


def test_cli_num_devices_spawns_two_ranks(tmp_path):
    """``python -m ...train_ndvi --num_devices 2 --device cpu``, in a process of
    its own that must end within the join bound: two ranks train an epoch,
    rank 0 alone logs."""
    data = str(tmp_path / "sen")
    make_sen12tp_tiles(data, n_tiles=1, size=64, seed=4, splits=("train", "val"))
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    argv = ["--checkpoint_path", str(ckpt), "--dataset_dir", data, "--seed", "1",
            "--max_epochs", "1", "--batch_size", "2", "--patch_size", "32", "--stride", "32",
            "--num_subnetworks", "2", "--filter_base_count", "4", "--precision", "f32",
            "--device", "cpu", "--num_devices", "2", "-i", "VV_sigma0", "-i", "VH_sigma0",
            "-t", "NDVI", "--log_every_n_steps", "1"]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "mimo_unet_torch.scripts.train.train_ndvi",
                           *argv], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=JOIN_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    hp = json.loads((ckpt / "last" / "hparams.json").read_text())
    assert hp["in_channels"] == 2 and hp["num_subnetworks"] == 2
    rows = [json.loads(line) for line in (ckpt / "metrics.tsv").read_text().splitlines()]
    assert [r["step"] for r in rows if "train_loss" in r] == [0, 1]  # rank 0's only
    assert np.isfinite([r["val_loss"] for r in rows if "val_loss" in r]).all()


@pytest.mark.parametrize("device,backend", [("cpu", "gloo"), (None, "nccl")])
def test_cli_under_torchrun_takes_the_device_backend(device, backend, monkeypatch):
    """Under torchrun's environment ``run_training`` starts the group on the
    backend its ``--device`` needs: gloo for CPU ranks on a host with cards,
    NCCL where every local rank has a card of its own."""
    from argparse import Namespace

    from mimo_unet_torch import cli

    class Started(Exception):
        pass

    seen = []

    def initialize(*args, backend=None, **kwargs):
        seen.append(backend)
        raise Started

    monkeypatch.setattr(multihost, "initialize_multihost", initialize)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    for k, v in (("WORLD_SIZE", "2"), ("LOCAL_WORLD_SIZE", "2"), ("RANK", "1")):
        monkeypatch.setenv(k, v)
    with pytest.raises(Started):
        cli.run_training(Namespace(num_devices=2, device=device), None, None)
    assert seen == [backend]
