"""What the drivers share: the task a configuration file states, and the
comparison of a reading with the reference's."""

from __future__ import annotations

import contextlib
from typing import Sequence

import numpy as np
import torch

TASK_KEYS = ("loss", "learning_rate", "weight_decay", "loss_buffer_size",
             "loss_buffer_temperature", "input_repetition_probability",
             "batch_repetitions", "scheduler_step_size", "scheduler_gamma",
             "center_dropout_rate", "final_dropout_rate", "encoder_dropout_rate",
             "core_dropout_rate", "decoder_dropout_rate")


def make_task(cfg: dict, seed: int):
    """The program's ``MimoUnetTask`` as the configuration states it."""
    from mimo_unet_torch.tasks.mimo import MimoUnetTask

    return MimoUnetTask(
        in_channels=cfg["in_channels"], out_channels=cfg["out_channels"],
        num_subnetworks=cfg["num_subnetworks"],
        filter_base_count=cfg["filter_base_count"],
        compute_dtype=cfg["compute_dtype"], seed=seed,
        **{k: cfg["task"][k] for k in TASK_KEYS if k in cfg["task"]})


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: the reference's precision."""
    keep = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = keep


def norm_gaps(prog: Sequence[float], ref: Sequence[float]) -> np.ndarray:
    """Per leaf |norm_prog - norm_ref| over the larger of the leaf's
    reference norm and the median leaf's."""
    p, r = np.asarray(prog, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    return np.abs(p - r) / np.maximum(r, np.median(r))


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
