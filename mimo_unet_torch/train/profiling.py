"""Spans, traces, FLOPs and timing of the port.

Counterpart of ``mimo_unet_tpu/train/profiling.py``.  The reference's only
performance tooling is CUDA-event timing in measure_inference_speed.py
(reference :25-47).

Spans.  ``span(name)`` marks a stage of the port while a ``torch.profiler``
is collecting: it opens ``torch.profiler.record_function(name)``, a host
event on the profiler's own clock, the clock of the device intervals in the
same trace.  Otherwise it returns one shared null context: the gate,
``torch.autograd._profiler_enabled()``, is a fraction of a microsecond,
where ``record_function`` with no profiler on still costs some 15 us a
call (both on one x86 core).  A span adds only the profiler's own event:
no CUDA event, no synchronise, no tensor.  ``SPANS`` names every span the
port opens:

* the stages of ``Ensemble.predict`` (``mimo.predict`` around the call;
  ``.in``, ``.forward``, ``.fetch`` and ``.assemble`` partition it) and of
  ``MimoUnetTask.train_step`` (``mimo.train.input``, ``.forward``,
  ``.backward`` and ``.update`` partition it), and ``DeviceDataset.gather``
  (``mimo.data.gather``);
* the conv sites, named by site and not by the kernel that serves them:
  ``mimo.train_conv.<site>`` around each train conv and its BatchNorm
  (``models/fast_path.py`` ``_conv_bn``), ``mimo.train_conv_bwd.<site>``
  around its backward (``Conv3x3Train.backward``, on autograd's thread), and
  ``mimo.eval_conv.<site>`` around each fused DoubleConv of the eval route;
* the MC-dropout route's own (``MC_SPANS``): ``mimo.dropout.draw`` around
  ``DropoutSource.draw`` (``ops/dropout.py``: every live site's keep mask
  of a forward, train steps' too), and ``mimo.eval_conv.outc`` around the
  eval route's 1x1 out-conv (K11) where a live up4 or final dropout site
  keeps it out of the decoder's fused DoubleConv.

``trace(dir)`` around ``Trainer.fit``, a ``train_step`` loop or
``Ensemble.predict`` writes a Chrome trace (for Perfetto or TensorBoard)
holding those spans; with a card, each span also has its GPU-side
annotation, the device time of the work it launched.

``cost_analysis`` gives the FLOPs of one call by
``torch.utils.flop_counter.FlopCounterMode``, which counts the aten
operations a call dispatches (convolutions, matrix products); the
hand-written kernels of ``mimo_unet_torch/kernels`` launch through ctypes
and are not counted, so count a kernel-path step's FLOPs on its plain twin
(``ct_kernels="off"``).  ``timed_per_exec`` times a call with CUDA events
after a warm-up; on the CPU it raises rather than give a host number under
a device metric's name.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

# the train route's six convs and the eval route's four fused DoubleConvs
TRAIN_CONV_SITES = ("in.c1", "in.c2", "down1.c1", "down1.c2", "dec.c1", "dec.c2")
EVAL_CONV_SITES = ("in_conv", "down1", "up3", "decoder")
# spans that open only where dropout is live
MC_SPANS = ("mimo.dropout.draw", "mimo.eval_conv.outc")

SPANS = (
    "mimo.predict",
    "mimo.predict.in",
    "mimo.predict.forward",
    "mimo.predict.fetch",
    "mimo.predict.assemble",
    "mimo.data.gather",
    "mimo.train.input",
    "mimo.train.forward",
    "mimo.train.backward",
    "mimo.train.update",
    *(f"mimo.train_conv.{s}" for s in TRAIN_CONV_SITES),
    *(f"mimo.train_conv_bwd.{s}" for s in TRAIN_CONV_SITES),
    *(f"mimo.eval_conv.{s}" for s in EVAL_CONV_SITES),
    *MC_SPANS,
)

_OFF = contextlib.nullcontext()


def span(name: str):
    """``record_function(name)`` while a profiler collects, else a shared
    null context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


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
