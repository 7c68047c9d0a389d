"""Pluggable scalar/image logging.

Copied from ``mimo_unet_tpu/train/logging.py`` (the port imports nothing
of the JAX package).  The reference logs scalar families to
wandb/TensorBoard via Lightning (reference: mimo/models/mimo_unet.py:
249-291) and image grids via the OutputMonitor callbacks
(mimo/tasks/depth/callbacks.py:18-144).  Default here is a
dependency-free TSV + PNG writer; wandb/TensorBoard attach when available
(imported only when their logger is made).  Loggers receive plain
floats/numpy arrays: the trainer owns device-to-host transfer cadence.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np


class MetricLogger:
    def log_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        raise NotImplementedError

    def log_image(self, step: int, name: str, image: np.ndarray) -> None:
        raise NotImplementedError

    def log_checkpoint(self, path: str) -> None:
        """Archive a checkpoint directory (wandb log_model parity,
        reference train_nyuv2_depth.py:67-68).  Default: no-op."""

    def finish(self) -> None:
        pass


class NullLogger(MetricLogger):
    """Logs nothing: the logger of data-parallel ranks other than 0."""

    def log_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        pass

    def log_image(self, step: int, name: str, image: np.ndarray) -> None:
        pass


class TSVLogger(MetricLogger):
    """Append-only metrics.tsv (one JSON-ish row per log call) + PNG dumps."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self._f = open(os.path.join(self.root, "metrics.tsv"), "a", buffering=1)

    def log_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        row = {"step": int(step), "time": time.time()}
        row.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(row) + "\n")

    def log_image(self, step: int, name: str, image: np.ndarray) -> None:
        img_dir = os.path.join(self.root, "images")
        os.makedirs(img_dir, exist_ok=True)
        safe = name.replace("/", "_")
        try:
            from PIL import Image

            Image.fromarray(image).save(
                os.path.join(img_dir, f"{safe}_step{step}.png")
            )
        except ImportError:
            np.save(os.path.join(img_dir, f"{safe}_step{step}.npy"), image)

    def finish(self) -> None:
        self._f.close()


class WandbLogger(MetricLogger):
    """Optional wandb sink (project per script, full-config upload, like
    reference train scripts, train_nyuv2_depth.py:67-68)."""

    def __init__(self, project: str, config: Optional[dict] = None, save_dir: Optional[str] = None):
        import wandb  # gated: raises if unavailable

        self._wandb = wandb
        self.run = wandb.init(project=project, config=config or {}, dir=save_dir)
        # WandbMetricsDefiner equivalent (reference depth/callbacks.py:12-16):
        # run summaries track best-so-far values of the key metrics
        self.run.define_metric("metric_val/r2", summary="max")
        self.run.define_metric("metric_val/mae", summary="min")
        self.run.define_metric("metric_val/mse", summary="min")
        self.run.define_metric("val_loss", summary="min")

    def log_scalars(self, step, scalars):
        self.run.log({k: float(v) for k, v in scalars.items()}, step=int(step))

    def log_image(self, step, name, image):
        self.run.log({name: self._wandb.Image(image)}, step=int(step))

    def log_checkpoint(self, path):
        """Upload a checkpoint directory as a wandb model artifact — the
        reference's WandbLogger(log_model=True) behavior
        (train_nyuv2_depth.py:67-68)."""
        try:
            art = self._wandb.Artifact(f"model-{self.run.id}", type="model")
            art.add_dir(path)
            self.run.log_artifact(art)
        except Exception as e:
            print(f"[logging] wandb checkpoint upload failed: {e}")

    def finish(self):
        self.run.finish()


class TensorBoardLogger(MetricLogger):
    """TensorBoard event-file sink — the reference OutputMonitor's alternate
    logger (reference mimo/tasks/depth/callbacks.py:42-48 logs to wandb *or*
    a Lightning TensorBoardLogger).  Scalars via add_scalar, image grids via
    add_image(dataformats="HWC"), matching the reference call shape."""

    def __init__(self, root: str):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # pragma: no cover - torch tb always in CI image
            from tensorboardX import SummaryWriter
        self.writer = SummaryWriter(log_dir=os.path.join(root, "tensorboard"))

    def log_scalars(self, step, scalars):
        for k, v in scalars.items():
            self.writer.add_scalar(k, float(v), global_step=int(step))

    def log_image(self, step, name, image):
        self.writer.add_image(
            name, np.asarray(image), global_step=int(step), dataformats="HWC"
        )

    def finish(self):
        self.writer.close()


class MultiLogger(MetricLogger):
    def __init__(self, *loggers: MetricLogger):
        self.loggers = [l for l in loggers if l is not None]

    def log_scalars(self, step, scalars):
        for l in self.loggers:
            l.log_scalars(step, scalars)

    def log_image(self, step, name, image):
        for l in self.loggers:
            l.log_image(step, name, image)

    def log_checkpoint(self, path):
        for l in self.loggers:
            l.log_checkpoint(path)

    def finish(self):
        for l in self.loggers:
            l.finish()


def make_logger(root: str, project: Optional[str] = None, use_wandb: bool = False,
                use_tensorboard: bool = False,
                config: Optional[dict] = None) -> MetricLogger:
    loggers = [TSVLogger(root)]
    if use_wandb:
        try:
            loggers.append(WandbLogger(project or "mimo-torch", config, root))
        except Exception as e:  # wandb missing or offline
            print(f"[logging] wandb unavailable ({e}); falling back to TSV only")
    if use_tensorboard:
        try:
            loggers.append(TensorBoardLogger(root))
        except Exception as e:
            print(f"[logging] tensorboard unavailable ({e}); skipping")
    return MultiLogger(*loggers)
