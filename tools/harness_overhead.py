#!/usr/bin/env python3
"""Where ``Trainer.fit``'s images/s go against a bare ``train_step`` loop,
on one GPU: the flagship task (S=2, fbc 21, bf16, Laplace) at 256x256 B=64
on synthetic NYUv2-schema uint8 frames, host-fed.

    python3 tools/harness_overhead.py [--epoch-steps N ...] [--turns N]

Each variant trains 3 epochs from a fresh state and reports the images/s
of epochs 1 and 2 (host clock around the epoch's steps, ending in a
synchronize; the trainer's own ``throughput_images_per_sec``) and, for
``fit``, the wall time of the whole call (3 epochs, validation and
checkpoints included):

  bare             ``train_step`` over ``DataModule.train_batches`` (numpy
                   batches, the step's pageable copy to the card)
  bare+prefetch    the same steps over ``prefetch_to_device`` (pinned
                   buffers, side-stream copies one batch ahead)
  fit              ``Trainer.fit`` (prefetch, logs every 50 steps,
                   validation, asynchronous checkpoints between epochs)
  fit, sync saves  ``Trainer.fit`` with checkpoints written before the
                   next epoch starts
  fit, no saves    ``Trainer.fit`` with checkpoints left out

at epochs of ``--epoch-steps`` steps (default 4 and 16), the variants in
turns (each order, then reversed, ``--turns`` times).  Exits non-zero
without CUDA.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 64
VARIANTS = ("bare", "bare+prefetch", "fit", "fit, sync saves", "fit, no saves")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epoch-steps", type=int, nargs="+", default=[4, 16])
    ap.add_argument("--turns", type=int, default=1)
    args = ap.parse_args()
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("harness_overhead: CUDA is not available")
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from mimo_unet_torch.data.core import ArrayDataset, DataModule, prefetch_to_device
    from mimo_unet_torch.kernels import _build
    from mimo_unet_torch.train.checkpoint import CheckpointManager
    from mimo_unet_torch.train.trainer import Trainer

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    _build.load_library()
    task = cs._train_task()
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)  # git-ignored, not checked out
    root = tempfile.mkdtemp(prefix="harness_overhead_", dir=os.path.join(REPO, "build"))

    class Frames(DataModule):
        batch_size = B

        def __init__(self, n):
            self.train = ArrayDataset(cs._nyu_arrays(n, 20))
            self.val = ArrayDataset(cs._nyu_arrays(B, 21))

        def setup(self):
            pass

        def train_dataset(self):
            return self.train

        def val_dataset(self):
            return self.val

    def bare(dm, prefetch):
        state = task.init_state(len(dm.train) // B, dev)
        rates = []
        for epoch in range(3):
            t0 = time.perf_counter()
            n = 0
            batches = dm.train_batches(epoch, seed=42)
            batches = (prefetch_to_device(batches, device=dev) if prefetch else
                       ({k: torch.from_numpy(v) for k, v in b.items()} for b in batches))
            for batch in batches:
                state, _, _ = task.train_step(state, batch)
                n += len(batch["image"])
            torch.cuda.synchronize()
            rates.append(n / (time.perf_counter() - t0))
        return rates[1:]

    def fit(dm, saves, run):
        path = os.path.join(root, str(run))
        t = Trainer(task, dm, max_epochs=3, checkpoint_path=path, log_every_n_steps=50,
                    log_images=False, device=dev)
        if saves == "sync":
            t.ckpt = CheckpointManager(path, task.hparams(), async_save=False)
        elif saves == "none":
            t.ckpt.save_last = lambda state: None
            t.ckpt.maybe_save_best = lambda *a: False
        t0 = time.perf_counter()
        t.fit()
        walls.setdefault(saves, []).append(time.perf_counter() - t0)
        return [h["throughput_images_per_sec"] for h in t.history[1:]]

    run = 0
    try:
        for steps in args.epoch_steps:
            dm = Frames(steps * B)
            rates = {v: [] for v in VARIANTS}
            walls = {}
            order = list(VARIANTS) + list(VARIANTS[::-1])
            for _ in range(args.turns):
                for v in order:
                    run += 1
                    if v.startswith("bare"):
                        rates[v] += bare(dm, prefetch=v == "bare+prefetch")
                    else:
                        rates[v] += fit(dm, {"fit": "async", "fit, sync saves": "sync",
                                             "fit, no saves": "none"}[v], run)
                    torch.cuda.empty_cache()
            base = sum(rates["bare"]) / len(rates["bare"])
            for v in VARIANTS:
                mean = sum(rates[v]) / len(rates[v])
                print(f"{steps} steps an epoch, {v}: {mean:.2f} images/s ({mean / base:.4f} of "
                      f"bare; epochs {[round(r, 2) for r in rates[v]]}) ({card})", flush=True)
            for saves, w in walls.items():
                print(f"{steps} steps an epoch, fit wall time, {saves} saves: "
                      f"{[round(x, 3) for x in w]} s ({card})", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
