"""Device-memory capacity ladder: make every batch size run.

Counterpart of ``mimo_unet_tpu/train/capacity.py``.  The saved full-res
activations of a train step grow with the batch (``PERF.md``: 7.74 GiB
at 256x256 B=64, 35.26 GiB at 640x480 B=64 on the H100), so a larger
batch or more subnetworks run the card out of memory.  ``make_train_step``
then retries the step with more recomputation (``MimoUNetConfig.remat``:
"none" -> "enc" -> "all", ``models/mimo_unet.py`` ``run_section``).
Remat replays the same kernels in the backward, so the step's numbers are
the same bits at every rung; it costs the recomputed sections' forward
time.

PyTorch has no ahead-of-time compile to probe with, so the first step
itself is the probe: an attempt that runs out of memory is undone (the
model's parameters, gradients and buffers, Adam's moments, the schedule,
the loss buffer, ``step`` and both generators, bit for bit) and the same
batch is tried one rung up.  As in the JAX package, ``Trainer`` does not
call the ladder: it is a library function.

Under a mesh of several ranks (``parallel/mesh.py`` ``ct_mesh_scope``)
every rank probes the rungs on its own rows with the collectives off
(every rank has the same shapes), undoing each probe; the ranks then agree
on the highest rung any of them needed, so that no rank is left waiting
in a collective by another that ran out of memory, and all take the step
at that rung together.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Optional, Tuple

import torch

from mimo_unet_torch.parallel.collectives import agree_max
from mimo_unet_torch.parallel.mesh import ct_mesh_scope, current_ct_mesh, spans_ranks

RUNGS = ("none", "enc", "all")


def is_cuda_oom(err: BaseException) -> bool:
    """True for the card running out of memory, the only failure the remat
    ladder can fix: ``torch.cuda.OutOfMemoryError`` or the caching
    allocator's message."""
    return (isinstance(err, torch.cuda.OutOfMemoryError)
            or "CUDA out of memory" in str(err))


def _snapshot(state):
    """Copies of everything a train step writes in ``state``."""
    model = state.model
    return {
        "model": {k: v.clone() for k, v in model.state_dict().items()},
        "grads": [None if p.grad is None else p.grad.clone()
                  for p in model.parameters()],
        "optimizer": copy.deepcopy(state.optimizer.state_dict()),
        "scheduler": copy.deepcopy(state.scheduler.state_dict()),
        "loss_buffer": (state.loss_buffer.buffer.clone(),
                        state.loss_buffer.index),
        "step": state.step,
        "generator": state.generator.get_state(),
        "dropout_generator": (None if state.dropout_generator is None
                              else state.dropout_generator.get_state()),
    }


def _restore(state, snap) -> None:
    """Put ``state`` back, bit for bit, as ``_snapshot`` found it, in
    place: the model's tensors stay the objects the optimizer holds."""
    model = state.model
    model.load_state_dict(snap["model"])
    for p, g in zip(model.parameters(), snap["grads"]):
        p.grad = g
    state.optimizer.load_state_dict(snap["optimizer"])
    state.scheduler.load_state_dict(snap["scheduler"])
    buffer, index = snap["loss_buffer"]
    state.loss_buffer.buffer.copy_(buffer)
    state.loss_buffer.index = index
    state.step = snap["step"]
    state.generator.set_state(snap["generator"])
    if state.dropout_generator is not None:
        state.dropout_generator.set_state(snap["dropout_generator"])


def make_train_step(task, state, batch, *, rungs: Tuple[str, ...] = RUNGS,
                    verbose: bool = True) -> Tuple[Callable, object]:
    """Find the first rung of ``rungs`` (from ``task.remat`` on) whose train
    step fits the card's memory at ``batch``, by running it.

    Returns ``(step_fn, task_used)``: ``task_used`` is ``task`` with that
    ``remat``, and ``step_fn(state, batch, with_outputs=False,
    dropout=None)`` is its ``train_step``.  The probe is the first step:
    on return ``state`` has taken it, on ``batch`` at the chosen rung (its
    logs are not kept).  An attempt that runs out of memory leaves
    ``state`` exactly as it found it; the rung is switched on the live
    model (``state.model.config``), whose weights stay.  Raises a failure that is not an out-of-memory error as it is,
    and the last one if every rung runs out of memory.  Under a mesh of
    several ranks ``batch`` is this rank's rows (see the module
    docstring)."""
    start = rungs.index(task.remat) if task.remat in rungs else 0
    if spans_ranks(current_ct_mesh()):
        return _agreed_rung(task, state, batch, rungs[start:], verbose)
    model = state.model
    last_err: Optional[BaseException] = None
    for rung in rungs[start:]:
        used = dataclasses.replace(task, remat=rung)
        model.config = dataclasses.replace(model.config, remat=rung)
        snap = _snapshot(state)
        try:
            used.train_step(state, batch)
        except Exception as e:  # noqa: BLE001 (classified, else re-raised)
            if not is_cuda_oom(e):
                raise
            # the traceback holds the failed attempt's activations
            last_err = e.with_traceback(None)
        else:
            if verbose and rung != task.remat:
                print(f"[capacity] train step needs remat={rung!r} to fit "
                      f"the card's memory at this batch size")
            return used.train_step, used
        _restore(state, snap)
        del snap
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    model.config = dataclasses.replace(model.config, remat=task.remat)
    raise last_err


def _fits(task, state, batch, rung: str) -> Optional[BaseException]:
    """Run one step at ``rung`` on this rank alone, then undo it: None if it
    fit, else its out-of-memory error (another failure is raised)."""
    used = dataclasses.replace(task, remat=rung)
    state.model.config = dataclasses.replace(state.model.config, remat=rung)
    snap = _snapshot(state)
    err = None
    try:
        with ct_mesh_scope(None):
            used.train_step(state, batch)
    except Exception as e:  # noqa: BLE001 (classified, else re-raised)
        if not is_cuda_oom(e):
            raise
        err = e.with_traceback(None)
    _restore(state, snap)
    del snap
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return err


def _agreed_rung(task, state, batch, rungs: Tuple[str, ...], verbose: bool):
    """The ladder over the ranks of the active mesh: each rank finds its
    first fitting rung alone, the ranks take the highest, then step
    together."""
    mesh = current_ct_mesh()
    last_err: Optional[BaseException] = None
    mine = len(rungs)  # no rung fits
    for i, rung in enumerate(rungs):
        last_err = _fits(task, state, batch, rung)
        if last_err is None:
            mine = i
            break
    agreed = agree_max(mine, mesh)
    if agreed == len(rungs):
        state.model.config = dataclasses.replace(state.model.config, remat=task.remat)
        if last_err is not None:
            raise last_err
        raise RuntimeError("another rank ran out of the card's memory at every rung")
    used = dataclasses.replace(task, remat=rungs[agreed])
    state.model.config = dataclasses.replace(state.model.config, remat=used.remat)
    used.train_step(state, batch)
    if verbose and used.remat != task.remat and mesh.is_main:
        print(f"[capacity] train step needs remat={used.remat!r} to fit "
              f"the card's memory at this batch size on every rank")
    return used.train_step, used
