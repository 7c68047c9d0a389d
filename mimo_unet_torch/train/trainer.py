"""Training harness: the Lightning-Trainer role on one card.

Counterpart of ``mimo_unet_tpu/train/trainer.py`` (:35-373): the train
step of ``tasks/mimo.py``; batches assembled on a background thread and
copied to the card on a side stream (``data/core.py``
``prefetch_to_device``), or, with ``device_cache``, the train split pinned
on the card and each batch gathered there (``DeviceDataset``; past the
budget ``PartialDeviceDataset``, whose host batches take the pinned
copies); scalar logs kept as device tensors and flushed one logging step
late, so the host never waits on the step it just queued; image-grid
monitoring (the reference's OutputMonitor callback); save_last +
best-by-val_loss checkpoints with resume.

Equivalent reference surface: pl.Trainer(...).fit(model, dm) as configured
in scripts/train/train_nyuv2_depth.py:70-82 (max_epochs,
log_every_n_steps, 16-mixed AMP -> compute_dtype="bfloat16",
ModelCheckpoint callbacks).

Data parallelism (``mesh`` or ``num_devices``, ``parallel/mesh.py``): one
process a card, each a rank of a ``torch.distributed`` process group
(started by torchrun, ``parallel.launch.spawn`` or ``--num_devices``).
``fit`` runs inside ``ct_mesh_scope``, so each step is the global batch's
(``tasks/mimo.py``); host-fed, every rank draws the same global batches
and copies only its rows to its card; with ``device_cache`` each rank pins
its shard (``DeviceDataset(mesh=)``) and gathers shard-local rows, and a
split past the budget is host-fed (a partial cache is single-device, as in
the JAX trainer).  Validation pads each batch to a multiple of the ranks
and weighs the padded rows 0.  Rank 0 alone logs (the global values) and
writes checkpoints; every rank resumes from the same ``last/``.
"""

from __future__ import annotations

import collections
import time
from typing import Optional

import numpy as np
import torch

from mimo_unet_torch.data.core import (
    DataModule,
    DeviceDataset,
    PartialDeviceDataset,
    dataset_nbytes,
    device_cache_budget_bytes,
    iterate_index_batches,
    iterate_sharded_index_batches,
    prefetch_to_device,
)
from mimo_unet_torch.parallel.collectives import agree_max, barrier
from mimo_unet_torch.parallel.mesh import (
    ct_mesh_scope,
    data_mesh,
    make_mesh,
    pad_batch_to_divisible,
    spans_ranks,
    spatial_count,
)
from mimo_unet_torch.train.checkpoint import CheckpointManager, load_checkpoint
from mimo_unet_torch.train.logging import MetricLogger, NullLogger, TSVLogger
from mimo_unet_torch.visualization import output_monitor_images

ROWS = "_rows"  # a cached batch's rows as the prefetcher carries them


class Trainer:
    def __init__(
        self,
        task,
        datamodule: DataModule,
        *,
        max_epochs: int,
        checkpoint_path: str,
        logger: Optional[MetricLogger] = None,
        log_every_n_steps: int = 200,
        monitor_mode: str = "depth",
        monitor_targets=None,
        log_images: bool = True,
        mesh=None,
        num_devices: Optional[int] = None,
        seed: int = 42,
        device_cache: bool = False,
        device_cache_budget: Optional[int] = None,
        host_chunk: int = 1,
        device=None,
    ):
        """The JAX Trainer's arguments, and ``device`` (the card when
        None; under a process group this rank's card, ``rank_device``).
        ``mesh`` (``parallel.make_mesh``, or a ``make_mesh_2d`` mesh of
        one spatial rank: its data axis; one that splits the height
        raises), else ``make_mesh(num_devices)``:
        a mesh of one without a process group, else the group's first
        ``num_devices`` ranks (all when None).  ``device_cache_budget`` is
        the bytes the device cache may take (None:
        ``device_cache_budget_bytes``).  ``host_chunk`` must be 1
        (``prefetch_to_device``)."""
        if host_chunk != 1:
            raise ValueError(f"host_chunk must be 1, got {host_chunk}")
        if spatial_count(mesh) > 1:
            raise ValueError(
                f"Trainer keeps a 1-D data mesh, as the JAX Trainer places its "
                f"batches with batch_sharding; a mesh that splits the height "
                f"({mesh.shape}) runs through the task's train_step and val_step "
                f"inside parallel.ct_mesh_scope(mesh), on batches from "
                f"parallel.shard_image")
        self.mesh = data_mesh(mesh) if mesh is not None else make_mesh(num_devices, device)
        self.task = task
        self.dm = datamodule
        self.max_epochs = max_epochs
        self.log_every_n_steps = log_every_n_steps
        self.monitor_mode = monitor_mode
        self.monitor_targets = monitor_targets
        self.log_images = log_images
        self.seed = seed
        self.device_cache = device_cache
        self.device_cache_budget = device_cache_budget
        self.device = self.mesh.device
        self.main = self.mesh.is_main  # the rank that logs and writes
        if not self.main:
            logger = NullLogger()
        self.logger = logger if logger is not None else TSVLogger(checkpoint_path)
        self.ckpt = CheckpointManager(
            checkpoint_path, task.hparams(),
            mesh=self.mesh if spans_ranks(self.mesh) else None)
        self.history: list = []
        # train batches handed to the step, by where they were gathered:
        # "cached" (on the card) or "host"
        self.batches_fed: collections.Counter = collections.Counter()
        self._timing_warm = False  # the first step of the process warms up

    # ------------------------------------------------------------------ fit

    def fit(self, resume: bool = False):
        """Train from epoch 0, or with ``resume`` from ``last/`` when it
        exists; validate and checkpoint after every epoch.  Returns the
        final ``TrainState``.  Under a mesh of several ranks every rank
        calls it, and the steps run inside ``ct_mesh_scope``."""
        with ct_mesh_scope(self.mesh):
            return self._fit(resume)

    def _fit(self, resume: bool):
        task, dm, dev, mesh = self.task, self.dm, self.device, self.mesh
        dm.setup()
        n_train = len(dm.train_dataset())
        steps_per_epoch = max(n_train // dm.batch_size, 1)
        if dm.batch_size % mesh.size != 0:
            raise ValueError(
                f"batch_size={dm.batch_size} must be divisible by the mesh "
                f"size ({mesh.size} devices); pass num_devices to shrink "
                f"the mesh or adjust --batch_size"
            )
        if dev.type == "cuda" and spans_ranks(mesh):
            from mimo_unet_torch.kernels import _build

            _build.load_library(mesh)  # rank 0 builds, the others wait
        barrier(mesh)  # no rank reads last/ before its writer has finished

        if resume and self.ckpt.has_last():
            _, state = load_checkpoint(self.ckpt.last_path, steps_per_epoch,
                                       device=dev)
            start_epoch = state.step // steps_per_epoch
            # a post-resume epoch with a worse val_loss must not overwrite
            # best/ (the reference's ModelCheckpoint keeps this in its own
            # state, train_nyuv2_depth.py:22-36)
            self.ckpt.restore_best_tracking()
            self._print(f"[trainer] resumed from step {state.step} (epoch {start_epoch})")
        else:
            state = task.init_state(steps_per_epoch, dev)
            start_epoch = 0

        cache = self._device_cache(dm.train_dataset()) if self.device_cache else None
        global_step = state.step
        for epoch in range(start_epoch, self.max_epochs):
            # ---------------- train ----------------
            t_epoch = time.perf_counter()
            images_seen = 0
            pending_logs = None
            for batch in self._train_batches(cache, epoch):
                want_images = (
                    self.log_images
                    and self.log_every_n_steps > 0
                    and global_step % self.log_every_n_steps == 0
                )
                state, logs, outputs = task.train_step(
                    state, batch, with_outputs=want_images)
                if want_images:
                    self._log_images(global_step, outputs, stage="train")
                images_seen += len(batch["image"]) * mesh.size
                if not self._timing_warm:
                    # the first step of the process builds the kernels and
                    # plans; restart the epoch clock so throughput reads
                    # the steady state
                    self._sync()
                    self._timing_warm = True
                    t_epoch = time.perf_counter()
                    images_seen = 0
                if self.log_every_n_steps > 0 and global_step % self.log_every_n_steps == 0:
                    # fetch the *previous* pending logs so the host never
                    # waits on the step it just queued
                    if pending_logs is not None:
                        self._flush_scalars(*pending_logs)
                    pending_logs = (global_step, logs)
                global_step += 1
            self._sync()
            dt = time.perf_counter() - t_epoch
            throughput = images_seen / dt if dt > 0 else 0.0
            if pending_logs is not None:
                self._flush_scalars(*pending_logs)

            # ---------------- validation ----------------
            val_logs = self.validate(state)
            epoch_scalars = {
                "epoch": epoch,
                "throughput_images_per_sec": throughput,
                **val_logs,
            }
            self.logger.log_scalars(global_step, epoch_scalars)
            self.history.append(epoch_scalars)
            self._print(
                f"[epoch {epoch}] {throughput:.1f} img/s  "
                + "  ".join(
                    f"{k}={v:.5f}" for k, v in val_logs.items() if k == "val_loss"
                )
            )

            # ---------------- checkpoint ----------------
            self.ckpt.save_last(state)
            if "val_loss" in val_logs:
                self.ckpt.maybe_save_best(
                    state, val_logs["val_loss"], epoch, global_step
                )
        # saves must be durable before fit() returns (resume and
        # checkpoint-archiving sinks read the directories right after)
        self.ckpt.wait_until_finished()
        # wandb log_model parity (reference train_nyuv2_depth.py:67-68):
        # sinks that archive checkpoints get the final one
        if hasattr(self.logger, "log_checkpoint"):
            self.logger.log_checkpoint(self.ckpt.last_path)
        return state

    # ------------------------------------------------------------------ data

    def _device_cache(self, train):
        """The train split on the card: whole when it fits the budget
        (``device_cache_budget``, else ``device_cache_budget_bytes``; no
        gate on the CPU), else the rows that fit, the rest streamed.  Under
        a mesh of several ranks each rank pins its shard when every rank's
        shard fits its budget, else none is pinned and the split is
        host-fed (the JAX trainer's fallback, :148-163)."""
        need = dataset_nbytes(train)
        budget = self.device_cache_budget
        if budget is None:
            budget = device_cache_budget_bytes(self.device)
        mesh = self.mesh
        if spans_ranks(mesh):
            per_dev = need // mesh.size
            # the ranks' budgets may differ: they agree before any pins
            if agree_max(int(budget is not None and per_dev > budget), mesh):
                self._print(f"[trainer] device cache disabled: split needs "
                            f"{per_dev / 1e6:.0f} MB/device > its budget on some "
                            f"rank (host-fed fallback; use more devices)")
                return None
            cache = DeviceDataset(train, device=self.device, mesh=mesh, seed=self.seed)
            self._print(f"[trainer] device cache: {len(cache)} items, "
                        f"{cache.nbytes / 1e6:.0f} MB a rank x {cache.n_shards} shards")
            return cache
        if budget is not None and need > budget:
            cache = PartialDeviceDataset(train, budget, device=self.device, seed=self.seed)
            print(f"[trainer] device cache (partial): {cache.n_cached}/{len(cache)} rows "
                  f"pinned ({cache.nbytes / 1e6:.0f} of {need / 1e6:.0f} MB; remainder "
                  f"streamed)")
            return cache
        cache = DeviceDataset(train, device=self.device)
        print(f"[trainer] device cache: {len(cache)} items, {cache.nbytes / 1e6:.0f} MB "
              f"on {self.device}")
        return cache

    def _train_batches(self, cache, epoch: int):
        """One epoch's train batches on the card.  Host-fed without a
        cache; with one, each batch's rows (drawn as the host-fed path
        draws them, ``iterate_index_batches``, or in the partial cache's
        stream) travel through ``prefetch_to_device`` beside the partial
        cache's host batches, and the cached ones are gathered on the
        card.  Under a mesh of several ranks each rank takes its rows of
        every host batch, or its row of each shard-local index batch."""
        dm, mesh = self.dm, self.mesh
        if cache is None:
            items = dm.train_batches(epoch, seed=self.seed)
            if spans_ranks(mesh):
                items = ({k: v[slice(*mesh.rows(len(v)))] for k, v in batch.items()
                          if v is not None} for batch in items)
        elif isinstance(cache, DeviceDataset) and cache.mesh is not None:
            items = ({ROWS: idx[mesh.rank]} for idx in iterate_sharded_index_batches(
                len(cache), cache.n_shards, dm.batch_size, shuffle=True,
                seed=self.seed, epoch=epoch))
        elif isinstance(cache, PartialDeviceDataset):
            items = ({ROWS: v} if kind == "cached" else v for kind, v in cache.epoch_batches(
                dm.batch_size, seed=self.seed, epoch=epoch, shuffle=True, drop_last=True))
            cache = cache.cached
        else:
            items = ({ROWS: idx} for idx in iterate_index_batches(
                len(cache), dm.batch_size, shuffle=True, drop_last=True,
                seed=self.seed, epoch=epoch))
        for batch in prefetch_to_device(items, device=self.device):
            if ROWS in batch:
                self.batches_fed["cached"] += 1
                yield cache.gather(batch[ROWS])
            else:
                self.batches_fed["host"] += 1
                yield batch

    # ------------------------------------------------------------ validation

    def validate(self, state) -> dict:
        """The val split's logs, each batch weighted by its rows (the JAX
        trainer's :330-352); the first batch's outputs (rank 0's rows) are
        logged as images.  Under a mesh of several ranks each batch is
        padded to a multiple of the ranks, its pad rows marked by a
        ``valid`` column of 0, and each rank runs ``val_step`` on its rows
        (whose logs are the global batch's)."""
        mesh = self.mesh
        sums: dict = {}
        count = 0
        first_outputs = None
        for batch in self.dm.val_batches():
            batch = {k: v for k, v in batch.items() if v is not None}
            batch, w = pad_batch_to_divisible(batch, mesh.size)
            b = len(next(iter(batch.values())))
            if w != b:
                # 0/1 row validity: pad rows must not enter any logged mean
                batch["valid"] = (np.arange(b) < w).astype(np.float32)
            rows = slice(*mesh.rows(b))
            batch = {k: torch.from_numpy(np.ascontiguousarray(v[rows]))
                     for k, v in batch.items()}
            logs, outputs = self.task.val_step(state.model, batch)
            if first_outputs is None:
                first_outputs = outputs
            # one wait on the card a batch
            values = torch.stack([v.float() for v in logs.values()]).tolist()
            for k, v in zip(logs, values):
                sums[k] = sums.get(k, 0.0) + v * w
            count += w
        if count == 0:
            return {}
        if self.log_images and first_outputs is not None:
            self._log_images(state.step, first_outputs, stage="val")
        return {k: v / count for k, v in sums.items()}

    # ---------------------------------------------------------------- helpers

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _print(self, message: str) -> None:
        if self.main:
            print(message)

    def _flush_scalars(self, step: int, logs) -> None:
        values = torch.stack([v.float() for v in logs.values()]).tolist()
        self.logger.log_scalars(step, dict(zip(logs, values)))

    def _log_images(self, step: int, outputs: dict, stage: str) -> None:
        if not (self.log_images and self.main):
            return
        try:
            host = {
                k: (v.float().cpu().numpy() if v is not None else None)
                for k, v in outputs.items()
            }
            images = output_monitor_images(
                host, self.monitor_mode, target_names=self.monitor_targets
            )
            for name, img in images.items():
                self.logger.log_image(step, f"{stage}/{name}", np.asarray(img))
        except Exception as e:  # noqa: BLE001 (monitoring must not stop training)
            print(f"[trainer] image logging failed: {e!r}")
