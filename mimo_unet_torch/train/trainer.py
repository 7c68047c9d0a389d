"""Training harness: the Lightning-Trainer role on one card.

Counterpart of ``mimo_unet_tpu/train/trainer.py`` (:35-373), host-fed
path: the train step of ``tasks/mimo.py``; batches assembled on a
background thread and copied to the card on a side stream
(``data/core.py`` ``prefetch_to_device``); scalar logs kept as device
tensors and flushed one logging step late, so the host never waits on the
step it just queued; image-grid monitoring (the reference's OutputMonitor
callback); save_last + best-by-val_loss checkpoints with resume.

Equivalent reference surface: pl.Trainer(...).fit(model, dm) as configured
in scripts/train/train_nyuv2_depth.py:70-82 (max_epochs,
log_every_n_steps, 16-mixed AMP -> compute_dtype="bfloat16",
ModelCheckpoint callbacks).

Not ported yet: the device-resident dataset (``device_cache``, ROADMAP
A.3) and data parallelism over several cards (``mesh``, ``num_devices``,
ROADMAP A.7); both raise.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from mimo_unet_torch.data.core import DataModule, prefetch_to_device
from mimo_unet_torch.models.mimo_unet import resolve_device
from mimo_unet_torch.train.checkpoint import CheckpointManager, load_checkpoint
from mimo_unet_torch.train.logging import MetricLogger, TSVLogger
from mimo_unet_torch.visualization import output_monitor_images


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
        None).  ``mesh``, ``num_devices`` > 1 (ROADMAP A.7) and
        ``device_cache`` (with its ``device_cache_budget``, ROADMAP A.3)
        raise; ``host_chunk`` must be 1 (``prefetch_to_device``)."""
        if mesh is not None or (num_devices or 1) > 1:
            raise NotImplementedError("training on several cards is not "
                                      "ported yet (ROADMAP A.7)")
        if device_cache:
            raise NotImplementedError("the device-resident dataset is not "
                                      "ported yet (ROADMAP A.3)")
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
        self.device = resolve_device(device)
        self.logger = logger if logger is not None else TSVLogger(checkpoint_path)
        self.ckpt = CheckpointManager(checkpoint_path, task.hparams())
        self.history: list = []
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

        global_step = state.step
        for epoch in range(start_epoch, self.max_epochs):
            # ---------------- train ----------------
            t_epoch = time.perf_counter()
            images_seen = 0
            pending_logs = None
            for batch in prefetch_to_device(
                    dm.train_batches(epoch, seed=self.seed), device=dev):
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
