"""Finding a cell's pieces by name, so a later change adds a cell, a
configuration, a traffic mix or a metric by adding files and entries only:

  BENCHMARK.json                       the cells, metrics and bounds
  <config entry's "file">              the configuration's sizes and task
  benchmark/traffic/<traffic>.json     the driver and its parameters
  benchmark/drivers/<driver>.py        one per entry point a window drives
  benchmark/limits/<cell>.json         the limits of the cell's check
  benchmark/layer_metrics/<name>.py    one reader per per-layer metric
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, end_to_end: List[dict]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" not in metric:
        return True
    moved = next(m for m in end_to_end if m["name"] == metric["moves"])
    return "workloads" not in moved or cell in moved["workloads"]


def load_cell(name: str, spec_path: Path = ROOT / "BENCHMARK.json",
              bench_dir: Path = BENCH_DIR) -> Cell:
    spec = load_json(spec_path)
    work = next((w for w in spec["workloads"] if w["name"] == name), None)
    if work is None:
        raise SystemExit(f"no workload {name!r} in {spec_path}")
    conf = next(c for c in spec["configs"] if c["name"] == work["config"])
    e2e = spec["end_to_end"]
    return Cell(
        name=name, chips=work["chips"],
        config=load_json(spec_path.parent / conf["file"]),
        traffic=load_json(bench_dir / "traffic" / f"{work['traffic']}.json"),
        limits=load_json(bench_dir / "limits" / f"{name}.json"),
        end_to_end=[m for m in e2e if _reports(m, name, e2e)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name, e2e)])


def _module(path: Path, name: str):
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def driver_class(traffic: dict, bench_dir: Path = BENCH_DIR):
    name = traffic["driver"]
    return _module(bench_dir / "drivers" / f"{name}.py", f"benchmark.drivers.{name}").Driver


def reader(metric: str, bench_dir: Path = BENCH_DIR) -> Callable:
    path = bench_dir / "layer_metrics" / f"{metric}.py"
    return _module(path, "benchmark_layer_metric_" + metric.replace(".", "_")).read
