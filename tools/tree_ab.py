#!/usr/bin/env python3
"""Train step times of this tree's port against another tree's, in turns,
on one GPU: whether a change to the port's Python (routing, autograd,
losses) moved a step, where the kernels are the same.

    python3 tools/tree_ab.py OTHER_TREE [--pairs N] [--steps STEP ...]

OTHER_TREE is a checkout of another commit (``git archive`` unpacked into
a git-ignored directory such as ``build/parent``).  Each turn is one
process started in one tree (its own ``mimo_unet_torch``, kernels built
into that tree's ``_build/`` at the first turn): for each step it trains
2 warm-up steps, times 20 (host clock around each step, ending in a
synchronize) and reports their median, then the device busy time of one
more step (``torch.profiler``, the sum of its device operations).  Turns
alternate this, other, other, this, ...; ``--pairs`` pairs of turns.
Steps (the flagship NYUv2-depth task, S=2, fbc 21, bf16, Laplace, seeded
uint8 frames): ``patch64`` (256x256 B=64), ``nyu16`` (640x480 B=16),
``final-dropout`` (640x480 B=4, final dropout 0.1).  Prints, per step and
measure, each turn's reading and the pairs where this tree was faster,
with the mean difference.  Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = {"patch64": (64, 256, 256, {}), "nyu16": (16, 480, 640, {}),
         "final-dropout": (4, 480, 640, {"final_dropout_rate": 0.1})}

WORKER = r"""
import json, os, sys, time
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
sys.path.insert(0, os.getcwd())
import torch
from mimo_unet_torch.tasks.mimo import MimoUnetTask
torch.backends.cudnn.allow_tf32 = False
out = {}
for name, (b, h, w, rates) in json.loads(sys.argv[1]).items():
    task = MimoUnetTask(in_channels=3, out_channels=2, num_subnetworks=2,
                        filter_base_count=21, loss="laplace_nll", learning_rate=1e-3,
                        loss_buffer_size=10, compute_dtype="bfloat16", **rates)
    state = task.init_state(-(-795 // b), "cuda")
    gen = torch.Generator().manual_seed(7)
    batches = [{"image": torch.randint(0, 256, (b, h, w, 3), generator=gen, dtype=torch.uint8),
                "label": torch.randint(0, 256, (b, h, w, 1), generator=gen, dtype=torch.uint8)}
               for _ in range(2)]
    times = []
    for i in range(22):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        task.train_step(state, batches[i % 2])
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        task.train_step(state, batches[0])
        torch.cuda.synchronize()
    busy = 0.0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(ev, "device_time_total", None)
            busy += us if us is not None else getattr(ev, "cuda_time_total", 0.0)
    out[name] = (times[len(times) // 2], busy / 1e3)
    del state
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(out))
"""


def run(tree: str, steps: dict) -> dict:
    proc = subprocess.run([sys.executable, "-c", WORKER, json.dumps(steps)], cwd=tree,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"turn in {tree} failed:\n{proc.stderr[-4000:]}")
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other")
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--steps", nargs="+", default=list(STEPS), choices=list(STEPS))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("tree_ab: CUDA is not available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    steps = {k: STEPS[k] for k in args.steps}
    trees = {"this": REPO, "other": os.path.abspath(args.other)}
    res = {"this": [], "other": []}
    for p in range(args.pairs):
        order = ("this", "other") if p % 2 == 0 else ("other", "this")
        for who in order:
            res[who].append(run(trees[who], steps))
            print(f"pair {p} {who}: {res[who][-1]}", flush=True)
    for name in steps:
        for i, measure in enumerate(("host median", "device busy")):
            this = [r[name][i] for r in res["this"]]
            other = [r[name][i] for r in res["other"]]
            diff = [a - b for a, b in zip(this, other)]
            faster = sum(d < 0 for d in diff)
            sd = statistics.stdev(diff) if len(diff) > 1 else 0.0
            print(f"{name} {measure}: this {[round(x, 3) for x in this]} ms, other "
                  f"{[round(x, 3) for x in other]} ms; this faster in {faster}/{len(diff)} "
                  f"pairs, mean this - other {statistics.mean(diff):+.3f} ms (sd {sd:.3f}) "
                  f"({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
