"""Run one benchmark cell of mimo_unet_torch and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One process: set-up (inputs and weights from the seed, the program's
objects, the first steps or requests, which warm every shape the cell
uses), then the measured window of ``--seconds``, then the check against
the plain reference.  ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics, read from a ``torch.profiler`` trace
of the window kept in memory.  The last line of standard output is the
result (JSON); the last lines of standard error list each number the
check compared beside its limit.  See benchmark/README.md.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every cache a run may write lives inside the checkout, at a fixed path
CACHE = ROOT / ".bench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names no run may load: the JAX reference package, JAX
# itself, and the repository's JAX-era tooling
FORBIDDEN = ("jax", "jaxlib", "flax", "mimo_unet_tpu", "chip_smoke", "tools", "bench")
GIB = 1024 ** 3


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_info(device) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i",
                              str(torch.device(device).index or 0)],
                             capture_output=True, text=True, timeout=20)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        info["power_limit_w"] = None
    return info


def launch_counts():
    from mimo_unet_torch.kernels import launch_counts as counts

    return {k: v for k, v in counts().items() if v}


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t0: float = None,
             err=sys.stderr) -> dict:
    """Set up, measure and check ``cell``; return the result line's dict."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark import cells, readers, yardstick
    from benchmark.drivers.common import synchronize
    from benchmark.trace import WINDOW, Trace
    from mimo_unet_torch.kernels import reset_launch_counts

    t0 = time.perf_counter() if t0 is None else t0
    cuda = torch.device(device).type == "cuda"
    driver = cells.driver_class(cell.traffic)(cell.config, cell.traffic, seed, device)
    driver.setup()
    synchronize(device)
    # a reference pass inside set-up (serving's BatchNorm statistics) is the
    # benchmark's, not the program's: its seconds are left out
    reference_setup_s = getattr(driver, "reference_setup_s", 0.0)
    setup_s = time.perf_counter() - t0 - reference_setup_s
    print("bench.setup " + json.dumps({"setup_s": setup_s,
                                       "reference_setup_s": reference_setup_s}),
          file=err, flush=True)
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    # ---- the window
    reset_launch_counts()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    prof = None
    if trace:
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts, record_shapes=False, with_stack=False)
        prof.start()
    with record_function(WINDOW):
        start = time.perf_counter()
        while True:
            driver.step()
            if time.perf_counter() - start >= seconds:
                break
        synchronize(device)
        elapsed = time.perf_counter() - start
    if prof is not None:
        prof.stop()
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    counts = driver.counts()
    info = card_info(device)
    print("bench.launches " + json.dumps({"card": info["kind"], "launch_counts":
                                          launch_counts()}), flush=True)

    # ---- metrics
    metrics, device_out, breakdown = {}, dict(info), None
    device_out["memory_peak_bytes"] = max(setup_peak, window_peak)
    if not trace:
        values = driver.end_to_end(elapsed)
        values["peak_mem_gib"] = window_peak / GIB
        values["setup_s"] = setup_s
        if hasattr(driver, "window_parts"):
            print("bench.window_parts " + json.dumps(driver.window_parts()), file=err,
                  flush=True)
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        tr = Trace.from_profiler(prof)
        del prof
        ctx = readers.ReadContext(trace=tr, counts=counts, config=cell.config,
                                  traffic=cell.traffic)
        for m in cell.per_layer:
            value = cells.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_out["busy_s"] = tr.busy_s
        device_out["window_s"] = tr.window_s
        breakdown = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps()}
        print("bench.peaks " + json.dumps({"card": info["kind"],
                                           "power_limit_w": info.get("power_limit_w"),
                                           **yardstick.PEAKS}), flush=True)
        del tr, ctx

    # ---- the check, with the program's state freed
    driver.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    readings = driver.readings()
    print("bench.readings " + json.dumps(readings), file=err, flush=True)
    # a reading that is not a finite number (an overflow) fails, as null
    check = {k: {"value": readings[k] if math.isfinite(readings[k]) else None, "limit": lim}
             for k, lim in cell.limits.items()}
    correct = all(c["value"] is not None and c["value"] <= c["limit"] for c in check.values())
    result = {"correct": correct, "attempted": counts.get("steps", counts.get("requests")),
              "failed": 0, "metrics": metrics, "device": device_out}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = check
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import cells

    cell = cells.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"bench: the cell needs {cell.chips} CUDA device(s); "
              f"cuda available: {torch.cuda.is_available()}", file=sys.stderr)
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", t0=T0)
    bad = forbidden_modules()
    if bad:
        print(f"bench: the run loaded forbidden modules: {bad}", file=sys.stderr)
        return 4
    for k, c in result["check"].items():
        print(f"check {k} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"check correct = {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
