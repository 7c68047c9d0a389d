"""Checkpoint/resume with the checkpoint-carries-hparams contract.

Counterpart of ``mimo_unet_tpu/train/checkpoint.py``.  The reference
relies on Lightning's ``save_hyperparameters`` so that
``load_from_checkpoint(path)`` rebuilds the model with zero config
(reference: mimo/models/mimo_unet.py:83-87, ensemble.py:42).  Here a
checkpoint directory holds ``state/state.pt`` (one ``torch.save`` file:
the model's ``state_dict``, the optimizer's and the schedule's state
dicts, the loss buffer, ``step`` and both generators' states) and
``hparams.json`` with the JAX package's schema, key for key;
``load_checkpoint`` restores the task and the state from them.

``load_checkpoint`` also reads a reference Lightning ``.ckpt`` file: the
model from ``interop.load_reference_checkpoint``, a fresh optimizer (as
the JAX package's ``_load_reference_ckpt``).  The port cannot read the JAX
package's Orbax ``state/`` directories.

hparams.json is committed after the state, never before: a crash
mid-write must not leave fresh hparams (with new "best" metadata) next to
a stale state.  An asynchronous save copies the state to the host before
it returns, stages ``hparams.json.pending`` and writes the state on the
manager's thread; ``CheckpointManager.wait_until_finished`` promotes the
staged file once its state write has succeeded.

Under a data mesh of several ranks every rank holds the same state, and
only rank 0 writes; ``wait_until_finished`` ends with a barrier, so no
rank reads a checkpoint before rank 0 has written it.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import torch

HPARAMS_FILE = "hparams.json"
STATE_DIR = "state"
STATE_FILE = "state.pt"


def _task_from_hparams(hparams: Dict[str, Any]):
    from mimo_unet_torch.tasks.evidential import EvidentialUnetTask
    from mimo_unet_torch.tasks.mimo import MimoUnetTask

    kind = hparams.get("task", "mimo_unet")
    classes = {"mimo_unet": MimoUnetTask, "evidential_unet": EvidentialUnetTask}
    if kind not in classes:
        raise ValueError(f"unknown task {kind!r} in hparams")
    field_names = {f.name for f in dataclasses.fields(classes[kind])}
    return classes[kind](**{k: v for k, v in hparams.items() if k in field_names})


def _to_host(obj):
    """``obj`` with every tensor copied to the host (nested dicts, lists
    and tuples)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def state_payload(state) -> Dict[str, Any]:
    """Everything of a ``TrainState`` a resume needs, on the host."""
    dropout_gen = state.dropout_generator
    return _to_host({
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "scheduler": state.scheduler.state_dict(),
        "loss_buffer": {"buffer": state.loss_buffer.buffer,
                        "index": state.loss_buffer.index},
        "step": int(state.step),
        "generator": state.generator.get_state(),
        "dropout_generator": (None if dropout_gen is None
                              else dropout_gen.get_state()),
    })


def _write_state(state_path: str, payload: Dict[str, Any]) -> None:
    """``payload`` to ``state_path/state.pt``, atomically (a temporary file
    renamed over it)."""
    os.makedirs(state_path, exist_ok=True)
    final = os.path.join(state_path, STATE_FILE)
    tmp = final + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, final)


def _write_json(path: str, hparams: Dict[str, Any]) -> None:
    with open(path, "w") as f:
        json.dump(hparams, f, indent=2, default=str)


def save_checkpoint(path: str, state, hparams: Dict[str, Any],
                    executor: Optional[concurrent.futures.Executor] = None
                    ) -> Optional[Tuple[concurrent.futures.Future, str]]:
    """Write ``state`` and ``hparams.json`` under ``path``.

    The state is copied to the host before this returns, so training may
    go on changing it.  Without ``executor`` the state is written, then
    hparams.json, and None is returned.  With one, ``hparams.json.pending``
    is staged, the state write is submitted, and (future, pending path) is
    returned: the caller promotes the pending file once the future has
    succeeded (``CheckpointManager.wait_until_finished``)."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    state_path = os.path.join(path, STATE_DIR)
    hp_final = os.path.join(path, HPARAMS_FILE)
    payload = state_payload(state)
    if executor is None:
        _write_state(state_path, payload)
        _write_json(hp_final, hparams)
        return None
    pending = hp_final + ".pending"
    _write_json(pending, hparams)
    return executor.submit(_write_state, state_path, payload), pending


def _promote_pending_hparams(pending: str) -> None:
    """Atomically publish a staged hparams file (state commit confirmed)."""
    if os.path.exists(pending):
        os.replace(pending, pending[: -len(".pending")])


def _read_hparams_file(path: str) -> Dict[str, Any]:
    """Read hparams.json, falling back to a staged .pending file when the
    final one is absent (a crash after the state committed but before the
    pending promote: the state is durable, so the pending hparams
    describe it)."""
    final = os.path.join(path, HPARAMS_FILE)
    if not os.path.exists(final) and os.path.exists(final + ".pending"):
        final = final + ".pending"
    with open(final) as f:
        return json.load(f)


def load_hparams(path: str) -> Dict[str, Any]:
    return _read_hparams_file(os.path.abspath(path))


def load_checkpoint(path: str, steps_per_epoch: int = 1, device=None):
    """Restore (task, TrainState) from a checkpoint directory, the state on
    ``device`` (the card when None).

    ``steps_per_epoch`` builds the schedule, whose position the restored
    state dict then sets.  A reference Lightning ``.ckpt`` file gives its
    task and model with a fresh optimizer (``_load_reference_ckpt``)."""
    if path.endswith(".ckpt") and os.path.isfile(path):
        return _load_reference_ckpt(path, steps_per_epoch, device)
    path = os.path.abspath(path)
    task = _task_from_hparams(load_hparams(path))
    state = task.init_state(steps_per_epoch, device)
    payload = torch.load(os.path.join(path, STATE_DIR, STATE_FILE),
                         map_location="cpu", weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.scheduler.load_state_dict(payload["scheduler"])
    state.loss_buffer.buffer.copy_(payload["loss_buffer"]["buffer"])
    state.loss_buffer.index = int(payload["loss_buffer"]["index"])
    state.step = int(payload["step"])
    state.generator.set_state(payload["generator"])
    if payload["dropout_generator"] is not None:
        state.dropout_generator.set_state(payload["dropout_generator"])
    return task, state


def _load_reference_ckpt(path: str, steps_per_epoch: int, device=None):
    """A reference Lightning checkpoint as (task, TrainState): the task
    from its hyperparameters, the model's weights and BatchNorm statistics
    from its state dict (strictly), everything else fresh.  Hyperparameters
    that name no task give a MIMO task, as in the JAX package
    (``mimo_unet_tpu/train/checkpoint.py:156``)."""
    from mimo_unet_torch.interop import load_reference_checkpoint

    sd, hparams = load_reference_checkpoint(path)
    task = _task_from_hparams({"task": "mimo_unet", **hparams})
    state = task.init_state(steps_per_epoch, device)
    state.model.load_state_dict(sd)
    return task, state


class CheckpointManager:
    """save_last + best-by-val_loss retention, like the reference's
    ModelCheckpoint callbacks (train_nyuv2_depth.py:22-36).  Asynchronous
    saves run in order on one thread the manager starts at its first
    save and stops in ``wait_until_finished``.  With a ``mesh`` of several
    ranks only rank 0 writes, and every rank tracks the best val_loss."""

    def __init__(self, root: str, hparams: Dict[str, Any],
                 async_save: bool = True, mesh=None):
        self.root = os.path.abspath(root)
        self.hparams = hparams
        self.best_val_loss = float("inf")
        self._async = async_save
        self._executor: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._pending: List[Tuple[concurrent.futures.Future, str]] = []
        self.mesh = mesh
        self.writes = mesh is None or mesh.is_main
        if self.writes:
            os.makedirs(self.root, exist_ok=True)

    def wait_until_finished(self) -> None:
        """Block until every dispatched save has finished, then publish the
        staged hparams file of each save whose state write succeeded (the
        state-first order of ``save_checkpoint``); raise the first failed
        write's error.  Under a mesh every rank then waits for the others
        (rank 0's writes are durable when any rank returns)."""
        pending, self._pending = self._pending, []
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None
        error = None
        for future, hp in pending:
            e = future.exception()
            if e is None:
                _promote_pending_hparams(hp)
            elif error is None:
                error = e
        if error is not None:
            raise error
        if self.mesh is not None:
            from mimo_unet_torch.parallel.collectives import barrier

            barrier(self.mesh)

    @property
    def last_path(self) -> str:
        return os.path.join(self.root, "last")

    @property
    def best_path(self) -> str:
        return os.path.join(self.root, "best")

    def _save(self, path: str, state, hparams) -> None:
        if not self.writes:
            return
        executor = None
        if self._async:
            if self._executor is None:
                self._executor = concurrent.futures.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="checkpoint")
            executor = self._executor
        staged = save_checkpoint(path, state, hparams, executor=executor)
        if staged is not None:
            self._pending.append(staged)

    def save_last(self, state) -> None:
        self._save(self.last_path, state, self.hparams)

    def maybe_save_best(self, state, val_loss: float, epoch: int, step: int) -> bool:
        if val_loss < self.best_val_loss:
            self.best_val_loss = float(val_loss)
            hp = dict(self.hparams)
            hp["best"] = {"epoch": epoch, "step": step, "val_loss": float(val_loss)}
            self._save(self.best_path, state, hp)
            return True
        return False

    def restore_best_tracking(self) -> float:
        """Reload best_val_loss from best/hparams.json (written by
        maybe_save_best) so resumed runs never regress best/.  Called by the
        trainer on resume only: a fresh fit into a reused directory starts
        tracking from scratch, like a new Lightning ModelCheckpoint."""
        if os.path.isdir(os.path.join(self.best_path, STATE_DIR)):
            try:
                best = _read_hparams_file(self.best_path).get("best", {})
            except FileNotFoundError:
                best = {}
            if "val_loss" in best:
                self.best_val_loss = float(best["val_loss"])
        return self.best_val_loss

    def has_last(self) -> bool:
        return os.path.isfile(os.path.join(self.last_path, STATE_DIR, STATE_FILE))
