"""Profiling and timing utilities.

Counterpart of ``mimo_unet_tpu/train/profiling.py``.  The reference's only
performance tooling is CUDA-event timing in measure_inference_speed.py
(reference :25-47).  Here: ``torch.profiler`` traces (Chrome trace, for
Perfetto or TensorBoard), CUDA-event timing after a warm-up, and the FLOPs
of one call by ``torch.utils.flop_counter.FlopCounterMode``.

Timing needs the card: on the CPU ``timed_per_exec`` raises rather than
give a host number under a device metric's name.  ``FlopCounterMode``
counts the aten operations a call dispatches (convolutions, matrix
products); the hand-written kernels of ``mimo_unet_torch/kernels`` launch
through ctypes and are not counted, so count a kernel-path step's FLOPs on
its plain twin (``ct_kernels="off"``).
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict

import torch
from torch.utils.flop_counter import FlopCounterMode


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` (CPU and, with a card, CUDA activity) around a
    block of work; writes ``log_dir/trace.json`` (Chrome trace format) and
    yields the profiler (``key_averages()`` for sums by operation)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def cost_analysis(fn: Callable, *example_args) -> Dict[str, float]:
    """FLOPs of one call ``fn(*example_args)``, as ``FlopCounterMode``
    counts its aten operations (the hand-written kernels are not counted;
    see the module docstring)."""
    with FlopCounterMode(display=False) as counter:
        fn(*example_args)
    return {"flops": float(counter.get_total_flops())}


def timed_per_exec(fn: Callable, *args, reps: int = 20, warmup: int = 2) -> float:
    """Seconds per call of ``fn(*args)`` on the card: ``warmup`` calls, then
    CUDA events around ``reps`` back-to-back calls.  Raises without CUDA."""
    if not torch.cuda.is_available():
        raise RuntimeError("timed_per_exec times the card; CUDA is not "
                           "available")
    for _ in range(warmup):
        fn(*args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / reps


def throughput_report(fn: Callable, *args, batch_size: int, reps: int = 20) -> dict:
    """Seconds per call, items/s and achieved TFLOP/s (``cost_analysis``'s
    FLOPs over the time)."""
    per_exec = timed_per_exec(fn, *args, reps=reps)
    costs = cost_analysis(fn, *args)
    return {
        "sec_per_exec": per_exec,
        "items_per_sec": batch_size / per_exec,
        "tflops_per_sec": costs["flops"] / per_exec / 1e12,
    }
