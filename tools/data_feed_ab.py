#!/usr/bin/env python3
"""Images/s of ``Trainer.fit`` by how its batches are fed, on one GPU: the
flagship task (S=2, fbc 21, bf16, Laplace NLL) at NYUv2's 640x480 frames,
B=16, on synthetic frames in NYUv2's uint8 schema.

    python3 tools/data_feed_ab.py [--turns N] [--frames N]

Modes, one epoch of ``fit`` each (``--frames`` train frames, 16 val
frames), in turns (the order, then reversed, ``--turns`` times):

  cached        ``Trainer(device_cache=True)``: each batch gathered on the
                card
  host native   host-fed, each batch gathered by ``data/_native`` (the
                default)
  host numpy    host-fed, each batch gathered by numpy (the native gather
                declined, as on a one-core host)

Per mode: the trainer's images/s of each epoch (host clock, the first step
left out), their median and spread, and the gathers by path.  Exits
non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("cached", "host native", "host numpy")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--frames", type=int, default=1024)
    args = ap.parse_args()
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("data_feed_ab: CUDA is not available")
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from mimo_unet_torch.data import _native
    from mimo_unet_torch.kernels import _build
    from mimo_unet_torch.train.trainer import Trainer

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load_library()
    dev = torch.device("cuda", 0)
    arrays = cs._nyu_arrays(args.frames + cs.DATA_VAL, 40, cs.NYU)
    dm = cs._frames_module(arrays, args.frames)
    task = cs._train_task()
    native = _native.gather_rows

    def numpy_only(src, idx, num_threads=1):
        return native(src, idx, num_threads=1)  # declines, counted as numpy

    rates = {m: [] for m in MODES}
    counts = {m: {} for m in MODES}
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)  # git-ignored
    root = tempfile.mkdtemp(prefix="data_feed_ab_", dir=os.path.join(REPO, "build"))
    try:
        order = list(MODES) + list(MODES[::-1])
        for turn, mode in enumerate(order * args.turns):
            _native.gather_rows = numpy_only if mode == "host numpy" else native
            _native.reset_counts()
            trainer = Trainer(task, dm, max_epochs=1, log_every_n_steps=8, log_images=False,
                              checkpoint_path=os.path.join(root, f"t{turn}"), device=dev,
                              device_cache=mode == "cached")
            trainer.fit()
            rates[mode].append(trainer.history[0]["throughput_images_per_sec"])
            counts[mode] = dict(_native.counts)
            del trainer
            torch.cuda.empty_cache()
    finally:
        _native.gather_rows = native
        shutil.rmtree(root, ignore_errors=True)
    for mode in MODES:
        r = rates[mode]
        print(f"fit {mode} {cs.NYU[0]}x{cs.NYU[1]} B={cs.TRAIN_B}, {args.frames // cs.TRAIN_B} "
              f"steps: images/s {[round(x, 3) for x in r]}, median {statistics.median(r):.3f}, "
              f"spread {max(r) - min(r):.3f}; gathers {counts[mode]} ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
