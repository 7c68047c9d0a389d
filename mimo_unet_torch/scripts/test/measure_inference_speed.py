"""Measure the latency of one ensemble prediction of a single image.

Counterpart of ``scripts/test/measure_inference_speed.py``, on the
reference protocol (reference scripts/test/measure_inference_speed.py:
22-47): 10 warm-up calls, then ``--repetitions`` timed calls, each ending
in a device synchronisation, printed as ``mean: ... ms, std: ... ms``.  The
second line is the per-call time of ``--repetitions`` back-to-back calls:
on a card from CUDA events around them (``per-exec (events)``), on the CPU
from the host clock (``per-exec (host clock)``).  Both lines name the
device (on a card, ``nvidia-smi``'s name and power limit):

    python -m mimo_unet_torch.scripts.test.measure_inference_speed \
        --model_checkpoint_paths ~/ckpts/a/last --in_channels 3 \
        --height 480 --width 640
"""

import os
import subprocess
import sys
import time
from argparse import ArgumentParser

import numpy as np
import torch

if __package__ in (None, ""):  # run by its path: make the package importable
    sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "..")))

from mimo_unet_torch.models.ensemble import Ensemble

WARMUP = 10


def build_parser() -> ArgumentParser:
    parser = ArgumentParser()
    parser.add_argument("--model_checkpoint_paths", nargs="+", type=str, required=True)
    parser.add_argument("--monte_carlo_steps", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--in_channels", type=int, required=True)
    parser.add_argument("--height", type=int, required=True)
    parser.add_argument("--width", type=int, required=True)
    parser.add_argument("--repetitions", type=int, default=1000)
    return parser


def device_label(device: torch.device) -> str:
    """The card's ``nvidia-smi`` name and power limit, else torch's name."""
    if device.type != "cuda":
        return device.type
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={device.index or 0}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
        if out:
            return out
    except (OSError, subprocess.SubprocessError):
        pass
    return torch.cuda.get_device_name(device)


def main(args):
    """Print both lines; returns (per-call ms of the timed calls,
    per-exec ms)."""
    device = torch.device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    model = Ensemble.from_checkpoints(
        args.model_checkpoint_paths,
        monte_carlo_steps=args.monte_carlo_steps,
        return_raw_predictions=False,
        device=device,
    )
    gen = torch.Generator().manual_seed(0)
    dummy = torch.randn((1, args.height, args.width, args.in_channels),
                        generator=gen).to(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(WARMUP):
        model(dummy)
    sync()

    repetitions = args.repetitions
    timings = np.zeros(repetitions)
    for rep in range(repetitions):
        t0 = time.perf_counter()
        model(dummy)
        sync()
        timings[rep] = (time.perf_counter() - t0) * 1000.0
    label = device_label(device)
    print(f"mean: {timings.mean():.3f} ms, std: {timings.std():.3f} ms ({label})")

    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(repetitions):
            model(dummy)
        end.record()
        end.synchronize()
        per_exec, how = start.elapsed_time(end) / repetitions, "events"
    else:
        t0 = time.perf_counter()
        for _ in range(repetitions):
            model(dummy)
        per_exec, how = (time.perf_counter() - t0) * 1000.0 / repetitions, "host clock"
    print(f"per-exec ({how}): {per_exec:.3f} ms ({label})")
    return timings, per_exec


if __name__ == "__main__":
    main(build_parser().parse_args())
