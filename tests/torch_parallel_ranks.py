"""What each rank runs for tests/test_torch_parallel.py (CPU, gloo).

``run_ranks(out_dir, inputs)`` is the function ``parallel.launch.spawn``
runs in every rank of a two-rank process group; it imports torch and the
port only.  Each scenario returns what the test holds against its
single-process or JAX reference; the rank saves them all to
``out_dir/rank<r>.pt`` with ``torch.save``.  Shared sizes and data makers
live here too, so the test builds its references from the same numbers.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch

# the train slice of tests/test_torch_train.py: the JAX package's aligned
# route at (B, S, H, W) = (., 2, 32, 256), fbc 6
H, W = 32, 256
GLOBAL_B = 4
TASK = dict(in_channels=3, out_channels=2, num_subnetworks=2, filter_base_count=6,
            loss="laplace_nll")
# the trainer runs: fbc 4 at 32x32 (tests/test_torch_trainer.py)
FIT_TASK = dict(in_channels=3, out_channels=2, num_subnetworks=2, filter_base_count=4,
                input_repetition_probability=0.5)
FIT_HW, FIT_TRAIN, FIT_VAL, FIT_B = 32, 8, 5, 4
# kernel route: a generator seed whose main permutation keeps each rank's
# half on that rank (checked by the test), so its BatchNorm inputs differ
KERNEL_GEN_SEED = 3
SKIP = {"kernel": 0, "core": 2}  # the all_reduce_sum call a variant skips


def halves_batch(seed: int, b: int = GLOBAL_B, hw=(H, W), mask: bool = True):
    """A global uint8/float batch whose rank halves come from different
    distributions: rank 0's images in [0, 80) and labels in [0, 0.3),
    rank 1's in [150, 256) and [0.6, 1)."""
    rng = np.random.default_rng(seed)
    half = b // 2
    image = np.concatenate([rng.integers(0, 80, (half, *hw, 3), dtype=np.uint8),
                            rng.integers(150, 256, (b - half, *hw, 3), dtype=np.uint8)])
    label = np.concatenate([rng.uniform(0, 0.3, (half, *hw, 1)),
                            rng.uniform(0.6, 1.0, (b - half, *hw, 1))]).astype(np.float32)
    out = {"image": image, "label": label}
    if mask:
        out["mask"] = (rng.uniform(0, 1, (b, *hw, 1)) > 0.2).astype(np.uint8)
    return out


def fit_arrays(n: int, seed: int):
    """uint8 NYUv2-schema frames, rank halves of every batch apart."""
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, (n, FIT_HW, FIT_HW, 3), dtype=np.uint8)
    image[n // 2:] = image[n // 2:] // 3
    return {"image": image,
            "label": rng.integers(0, 256, (n, FIT_HW, FIT_HW, 1), dtype=np.uint8)}


def make_datamodule():
    from mimo_unet_torch.data.core import ArrayDataset, DataModule

    class Frames(DataModule):
        batch_size = FIT_B

        def setup(self):
            self.train = ArrayDataset(fit_arrays(FIT_TRAIN, 0))
            self.val = ArrayDataset(fit_arrays(FIT_VAL, 1))

        def train_dataset(self):
            return self.train

        def val_dataset(self):
            return self.val

    return Frames()


def torch_batch(batch, rows=slice(None)):
    return {k: torch.from_numpy(np.ascontiguousarray(v[rows])) for k, v in batch.items()}


def fresh_state(task, state_dict=None, gen_seed: int = 0, loss_buffer=None):
    """A TrainState on the CPU: the task's seeded weights (or
    ``state_dict``), the input transform's generator seeded ``gen_seed``."""
    from mimo_unet_torch.loss_buffer import LossBufferState
    from mimo_unet_torch.tasks.mimo import TrainState

    state = task.init_state(1, "cpu")
    if state_dict is not None:
        state.model.load_state_dict(state_dict)
    if loss_buffer is not None:
        buffer, index = loss_buffer
        state.loss_buffer = LossBufferState(buffer=torch.as_tensor(buffer).clone(),
                                            index=index)
    return TrainState(step=0, model=state.model, optimizer=state.optimizer,
                      scheduler=state.scheduler, loss_buffer=state.loss_buffer,
                      generator=torch.Generator().manual_seed(gen_seed),
                      dropout_generator=state.dropout_generator)


def step_record(state, logs):
    """What a step left: logs, gradients, Adam's first moments, parameters,
    BatchNorm buffers and the loss buffer."""
    model = state.model
    return {
        "logs": {k: float(v) for k, v in logs.items()},
        "grads": {k: p.grad.detach().clone() for k, p in model.named_parameters()},
        "exp_avg": {k: state.optimizer.state[p]["exp_avg"].clone()
                    for k, p in model.named_parameters()},
        "params": {k: p.detach().clone() for k, p in model.named_parameters()},
        "buffers": {k: v.clone() for k, v in model.state_dict().items()
                    if k.endswith(("running_mean", "running_var", "num_batches_tracked"))},
        "loss_buffer": state.loss_buffer.buffer.clone(),
        "lb_index": state.loss_buffer.index,
    }


@contextlib.contextmanager
def recorded_rows(store: list):
    """Record the transformed rows each ``MimoUnetTask.objective`` call
    sees (this rank's slice under a mesh), and under "own" whether each
    holds its own storage (no view into a larger, global tensor that the
    forward and backward would keep alive)."""
    from mimo_unet_torch.tasks.mimo import MimoUnetTask

    objective = MimoUnetTask.objective

    def recording(self, model, image_t, label_t, mask_t, *args, **kwargs):
        rows = {"image": image_t, "label": label_t, "mask": mask_t}
        store.append({k: None if t is None else t.clone() for k, t in rows.items()})
        store[-1]["own"] = {k: t.untyped_storage().nbytes() == t.numel() * t.element_size()
                            for k, t in rows.items() if t is not None}
        return objective(self, model, image_t, label_t, mask_t, *args, **kwargs)

    MimoUnetTask.objective = recording
    try:
        yield
    finally:
        MimoUnetTask.objective = objective


@contextlib.contextmanager
def skipping(module, index: int):
    """``module.all_reduce_sum``'s call number ``index`` returns its input
    unchanged (a BatchNorm site left rank-local)."""
    real = module.all_reduce_sum
    calls = [0]

    def maybe(x, *args, **kwargs):
        calls[0] += 1
        if calls[0] - 1 == index:
            return x
        return real(x, *args, **kwargs)

    module.all_reduce_sum = maybe
    try:
        yield
    finally:
        module.all_reduce_sum = real


# ------------------------------------------------------------------ scenarios

def jax_step(mesh, inputs):
    """One f32 plain-route step of the JAX-transplanted weights."""
    from mimo_unet_torch.parallel.mesh import ct_mesh_scope
    from mimo_unet_torch.tasks.mimo import MimoUnetTask

    task = MimoUnetTask(**inputs["jax_hp"])
    state = fresh_state(task, inputs["jax_sd"], loss_buffer=inputs["jax_lb"])
    with ct_mesh_scope(mesh):
        state, logs, _ = task.train_step(
            state, torch_batch(inputs["jax_batch"], slice(*mesh.rows(GLOBAL_B))))
    return step_record(state, logs)


def self_plain(mesh, inputs, steps: int = 2):
    """``steps`` f32 plain-route steps at p = 0.5, 2 batch repetitions."""
    from mimo_unet_torch.parallel.mesh import ct_mesh_scope
    from mimo_unet_torch.tasks.mimo import MimoUnetTask

    task = MimoUnetTask(**inputs["self_hp"])
    state = fresh_state(task)
    out = []
    for i in range(steps):
        rows = []
        with ct_mesh_scope(mesh), recorded_rows(rows):
            state, logs, _ = task.train_step(
                state, torch_batch(halves_batch(10 + i), slice(*mesh.rows(GLOBAL_B))))
        out.append(dict(step_record(state, logs), rows=rows[0]))
    return out


def kernel_step(mesh, inputs):
    """One step on the kernel route (plain twins on the CPU), its
    collectives counted; then the same step with one kernel site's and
    with one core site's all-reduce skipped."""
    from mimo_unet_torch.models import fast_path
    from mimo_unet_torch.ops import norm
    from mimo_unet_torch.parallel import collectives
    from mimo_unet_torch.parallel.mesh import ct_mesh_scope
    from mimo_unet_torch.tasks.mimo import MimoUnetTask

    task = MimoUnetTask(**inputs["kernel_hp"])
    batch = torch_batch(halves_batch(20, mask=False), slice(*mesh.rows(GLOBAL_B)))

    def run():
        state = fresh_state(task, gen_seed=KERNEL_GEN_SEED)
        rows = []
        with ct_mesh_scope(mesh), recorded_rows(rows):
            state, logs, _ = task.train_step(state, batch)
        return dict(step_record(state, logs), rows=rows[0])

    collectives.reset_counts()
    out = {"ok": run(), "counts": collectives.counts()}
    for name, module in (("kernel", fast_path), ("core", norm)):
        with skipping(module, SKIP[name]):
            out[f"skip_{name}"] = run()
    return out


def evidential_step(mesh, inputs):
    from mimo_unet_torch.parallel.mesh import ct_mesh_scope
    from mimo_unet_torch.tasks.evidential import EvidentialUnetTask

    task = EvidentialUnetTask(**inputs["ev_hp"])
    state = fresh_state(task)
    with ct_mesh_scope(mesh):
        state, logs, _ = task.train_step(
            state, torch_batch(halves_batch(30, mask=False), slice(*mesh.rows(GLOBAL_B))))
    return step_record(state, logs)


def ladder(mesh, inputs):
    """The capacity ladder with an out-of-memory error on rank 1 alone at
    "none": both ranks take "enc"."""
    from mimo_unet_torch.parallel.mesh import ct_mesh_scope
    from mimo_unet_torch.tasks.mimo import MimoUnetTask
    from mimo_unet_torch.train import capacity

    task = MimoUnetTask(**inputs["self_hp"])
    state = fresh_state(task)
    step = MimoUnetTask.train_step

    def failing(self, st, *args, **kwargs):
        out = step(self, st, *args, **kwargs)
        if mesh.rank == 1 and self.remat == "none":
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB")
        return out

    MimoUnetTask.train_step = failing
    try:
        with ct_mesh_scope(mesh):
            _, used = capacity.make_train_step(
                task, state, torch_batch(halves_batch(10), slice(*mesh.rows(GLOBAL_B))),
                verbose=False)
    finally:
        MimoUnetTask.train_step = step
    return {"rung": used.remat,
            "params": {k: p.detach().clone() for k, p in state.model.named_parameters()}}


def fits(mesh, out_dir):
    """Trainer.fit(num_devices=2): 2 epochs host-fed; with dropout, 2
    straight epochs and 1 epoch + a resume to 2 (compared bitwise here);
    1 epoch with the sharded device cache.  Counts each rank's checkpoint
    writes."""
    from mimo_unet_torch.tasks.mimo import MimoUnetTask
    from mimo_unet_torch.train import checkpoint
    from mimo_unet_torch.train.trainer import Trainer

    writes = [0]
    save = checkpoint.save_checkpoint

    def counting(*args, **kwargs):
        writes[0] += 1
        return save(*args, **kwargs)

    checkpoint.save_checkpoint = counting

    def fit(name, task, epochs, resume=False, **kw):
        trainer = Trainer(task, make_datamodule(), max_epochs=epochs,
                          checkpoint_path=os.path.join(out_dir, name), log_every_n_steps=1,
                          log_images=False, num_devices=2, device="cpu", **kw)
        return trainer, trainer.fit(resume=resume)

    task = MimoUnetTask(**FIT_TASK)
    trainer, state = fit("host", task, 2)
    out = {"history": trainer.history, "mesh_size": trainer.mesh.size,
           "host": {k: p.detach().clone() for k, p in state.model.named_parameters()}}
    drop = dataclasses.replace(task, decoder_dropout_rate=0.1, encoder_dropout_rate=0.1)
    _, straight = fit("straight", drop, 2)
    fit("resumed", drop, 1)
    _, resumed = fit("resumed", drop, 2, resume=True)
    out["resume"] = {k: torch.equal(a, b) for (k, a), (_, b) in zip(
        _state_tensors(resumed).items(), _state_tensors(straight).items())}
    cached_trainer, cached = fit("cached", task, 1, device_cache=True)
    out["cached_fed"] = dict(cached_trainer.batches_fed)
    out["cached_history"] = cached_trainer.history
    out["cached"] = {k: p.detach().clone() for k, p in cached.model.named_parameters()}
    checkpoint.save_checkpoint = save
    out["writes"] = writes[0]
    _, last = checkpoint.load_checkpoint(os.path.join(out_dir, "host", "last"), 2, device="cpu")
    out["last_equal"] = all(torch.equal(p, q) for p, q in zip(
        last.model.state_dict().values(), state.model.state_dict().values()))
    return out


def _state_tensors(state):
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    names = {id(p): k for k, p in state.model.named_parameters()}
    for p, st in state.optimizer.state.items():
        for k, v in st.items():
            out[f"adam.{names[id(p)]}.{k}"] = v
    out["loss_buffer"] = state.loss_buffer.buffer
    out["generator"] = state.generator.get_state()
    out["numbers"] = torch.tensor([state.step, state.loss_buffer.index,
                                   state.scheduler.last_epoch], dtype=torch.float64)
    return out


def stub_build(mesh, out_dir):
    """``load_library(mesh)`` on a fresh tree with a stubbed nvcc: a line a
    build in ``builds.txt``."""
    from pathlib import Path

    from mimo_unet_torch.kernels import _build

    lib = Path(out_dir) / "stub" / "lib.so"

    def build(path):
        with open(os.path.join(out_dir, "builds.txt"), "a") as f:
            f.write(f"rank {mesh.rank}\n")
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(b"")

    _build.library_path, _build._build, _build.bind = (
        lambda: lib, build, lambda path: ("bound", str(path)))
    _build._lib = None
    return _build.load_library(mesh)


def run_ranks(out_dir: str, inputs: dict) -> None:
    torch.set_num_threads(1)
    from mimo_unet_torch.parallel.mesh import make_mesh

    mesh = make_mesh(2, device="cpu")
    results = {"rank": mesh.rank, "size": mesh.size,
               "build": stub_build(mesh, out_dir),
               "jax_step": jax_step(mesh, inputs),
               "self_plain": self_plain(mesh, inputs),
               "kernel": kernel_step(mesh, inputs),
               "evidential": evidential_step(mesh, inputs),
               "ladder": ladder(mesh, inputs),
               "fits": fits(mesh, os.path.join(out_dir, "fits"))}
    torch.save(results, os.path.join(out_dir, f"rank{mesh.rank}.pt"))


def failing_rank() -> None:
    """Rank 1 raises at once; rank 0 would work on for a minute."""
    import time

    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails")
    time.sleep(60)
