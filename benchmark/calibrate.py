"""Readings that set a cell's check limits (benchmark/limits/<cell>.json).

    python3 benchmark/calibrate.py --workload <cell> --seeds <n> [--first-seed <n>]
        [--controls 3] [--faults 3] [--out <dir>]

In one process, for each seed: the program's readings as a run takes them
(its set-up and first steps, or its requests, against the float32
reference); on the first ``--controls`` seeds the control's readings (the
reference in fp8, ``reference/quant.py``, in the program's place); on the
first ``--faults`` seeds of a train cell the readings of the program with
half of each batch left out (the mean over the rest).  A step that leaves
the state unchanged reads 1 by the norm gaps' measure and needs no run.
Each reading is a JSON line on standard output and in
``<out>/calibrate_<cell>.jsonl``.  Needs the card; no window is measured.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@contextlib.contextmanager
def half_batch():
    """The program's train step sees the first half of each batch."""
    from mimo_unet_torch.tasks.mimo import MimoUnetTask

    orig = MimoUnetTask.train_step

    def step(self, state, batch, **kw):
        b = batch["image"].shape[0] // 2
        return orig(self, state, {k: v[:b] for k, v in batch.items()}, **kw)

    MimoUnetTask.train_step = step
    try:
        yield
    finally:
        MimoUnetTask.train_step = orig


def free(device):
    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def train_readings(cls, cell, seed, device, control, fault):
    from benchmark.reference.quant import fp8

    d = cls(cell.config, cell.traffic, seed, device)
    d.setup()
    d.release()
    free(device)
    ref = d.reference()
    out = [("program", d.compare(d.prog, ref))]
    if control:
        out.append(("control_fp8", d.compare(d.reference(quant=fp8), ref)))
    if fault:
        with half_batch():
            h = cls(cell.config, cell.traffic, seed, device)
            h.setup()
            h.release()
        free(device)
        out.append(("fault_half_batch", h.compare(h.prog, ref)))
    return out


def serve_readings(cls, cell, seed, device, control, fault):
    from benchmark.reference.quant import fp8

    d = cls(cell.config, cell.traffic, seed, device)
    d.setup()
    for _ in range(cell.traffic["pool_requests"]):
        d.step()
    d.release()
    free(device)
    out = [("program", d.readings())]
    if control:
        out.append(("control_fp8", d.worst([d.judge(d.reference(d._frames(r), quant=fp8),
                                                    d._frames(r)) for r, _ in d.kept])))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--out", default=".bench_cache/calibrate")
    args = ap.parse_args(argv)

    import torch

    from benchmark import cells

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 3
    cell = cells.load_cell(args.workload)
    cls = cells.driver_class(cell.traffic)
    fn = train_readings if cls.kind == "train" else serve_readings
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    with open(out / f"calibrate_{args.workload}.jsonl", "a") as log:
        for i in range(args.seeds):
            seed = args.first_seed + 7919 * i
            t0 = time.perf_counter()
            for what, readings in fn(cls, cell, seed, "cuda:0", i < args.controls,
                                     i < args.faults):
                line = json.dumps({"cell": args.workload, "seed": seed, "what": what,
                                   "readings": readings,
                                   "seconds": time.perf_counter() - t0})
                print(line, flush=True)
                log.write(line + "\n")
            free("cuda:0")
    return 0


if __name__ == "__main__":
    sys.exit(main())
