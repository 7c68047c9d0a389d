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

Not ported yet: data parallelism over several cards (``mesh``,
``num_devices``, ROADMAP A.7); it raises.
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
    prefetch_to_device,
)
from mimo_unet_torch.models.mimo_unet import resolve_device
from mimo_unet_torch.train.checkpoint import CheckpointManager, load_checkpoint
from mimo_unet_torch.train.logging import MetricLogger, TSVLogger
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
        None).  ``device_cache_budget`` is the bytes the device cache may
        take (None: ``device_cache_budget_bytes``).  ``mesh`` and
        ``num_devices`` > 1 raise (ROADMAP A.7); ``host_chunk`` must be 1
        (``prefetch_to_device``)."""
        if mesh is not None or (num_devices or 1) > 1:
            raise NotImplementedError("training on several cards is not "
                                      "ported yet (ROADMAP A.7)")
        if host_chunk != 1:
            raise ValueError(f"host_chunk must be 1, got {host_chunk}")
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
        self.device = resolve_device(device)
        self.logger = logger if logger is not None else TSVLogger(checkpoint_path)
        self.ckpt = CheckpointManager(checkpoint_path, task.hparams())
        self.history: list = []
        # train batches handed to the step, by where they were gathered:
        # "cached" (on the card) or "host"
        self.batches_fed: collections.Counter = collections.Counter()
        self._timing_warm = False  # the first step of the process warms up

    # ------------------------------------------------------------------ fit

    def fit(self, resume: bool = False):
        """Train from epoch 0, or with ``resume`` from ``last/`` when it
        exists; validate and checkpoint after every epoch.  Returns the
        final ``TrainState``."""
        task, dm, dev = self.task, self.dm, self.device
        dm.setup()
        n_train = len(dm.train_dataset())
        steps_per_epoch = max(n_train // dm.batch_size, 1)

        if resume and self.ckpt.has_last():
            _, state = load_checkpoint(self.ckpt.last_path, steps_per_epoch,
                                       device=dev)
            start_epoch = state.step // steps_per_epoch
            # a post-resume epoch with a worse val_loss must not overwrite
            # best/ (the reference's ModelCheckpoint keeps this in its own
            # state, train_nyuv2_depth.py:22-36)
            self.ckpt.restore_best_tracking()
            print(f"[trainer] resumed from step {state.step} (epoch {start_epoch})")
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
                images_seen += len(batch["image"])
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
            print(
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
        gate on the CPU), else the rows that fit, the rest streamed."""
        need = dataset_nbytes(train)
        budget = self.device_cache_budget
        if budget is None:
            budget = device_cache_budget_bytes(self.device)
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
        card."""
        dm = self.dm
        if cache is None:
            items = dm.train_batches(epoch, seed=self.seed)
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
        trainer's :330-352 on one device, where no batch is padded, so
        none carries a ``valid`` column); the first batch's outputs are
        logged as images."""
        sums: dict = {}
        count = 0
        first_outputs = None
        for batch in self.dm.val_batches():
            batch = {k: torch.from_numpy(v) for k, v in batch.items()
                     if v is not None}
            logs, outputs = self.task.val_step(state.model, batch)
            if first_outputs is None:
                first_outputs = outputs
            w = len(batch["image"])
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

    def _flush_scalars(self, step: int, logs) -> None:
        values = torch.stack([v.float() for v in logs.values()]).tolist()
        self.logger.log_scalars(step, dict(zip(logs, values)))

    def _log_images(self, step: int, outputs: dict, stage: str) -> None:
        if not self.log_images:
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
