"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name."""

import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark import cells

ROOT = cells.ROOT
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"][1].startswith("benchmark/")
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units_use_the_allowed_characters():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
            for text in ("why", "layer", "source"):
                if text in entry:
                    assert 1 <= len(entry[text]) <= 200 and "\n" not in entry[text]
                    assert "\t" not in entry[text]
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1
    for c in SPEC["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    assert len(names) == len(set(names))


def test_metric_entries():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["better"] in ("lower", "higher")
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["moves"] in e2e


def test_every_per_layer_metrics_cells_report_what_it_moves():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    cell_names = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cell_names):
            assert cell in cell_names
            assert "workloads" not in moved or cell in moved["workloads"], (m["name"], cell)


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in SPEC["workloads"]:
        cell = cells.load_cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        assert cell.limits


@pytest.mark.parametrize("work", SPEC["workloads"], ids=lambda w: w["name"])
def test_every_cells_files_are_found_by_name(work):
    cell = cells.load_cell(work["name"])
    assert cells.driver_class(cell.traffic).kind in ("train", "serve")
    for m in cell.per_layer:
        assert callable(cells.reader(m["name"]))
    conf = next(c for c in SPEC["configs"] if c["name"] == work["config"])
    assert conf["file"].startswith("benchmark/configs/")
    assert cell.config["name"] == conf["name"]
    assert cell.config["reduced"] == conf["reduced"]


def test_a_cell_and_a_metric_added_as_files_are_picked_up(tmp_path):
    """A later change adds a traffic file, a limits file, a reader and two
    entries; no file already there changes."""
    bench = tmp_path / "benchmark"
    shutil.copytree(cells.BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "nyuv2_train_b16", "config": "nyuv2_depth_s2_f21",
                              "traffic": "train_b16", "chips": 1, "why": "a smaller batch"})
    spec["end_to_end"][0]["workloads"].append("nyuv2_train_b16")
    spec["per_layer"].append({"name": "gather_ms", "unit": "ms", "better": "lower",
                              "source": "device_trace", "layer": "data",
                              "moves": "train_images_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    traffic = json.loads((bench / "traffic" / "train_b64.json").read_text()) | {"batch": 16}
    (bench / "traffic" / "train_b16.json").write_text(json.dumps(traffic))
    (bench / "limits" / "nyuv2_train_b16.json").write_text('{"loss1_rel": 0.1}')
    (bench / "layer_metrics" / "gather_ms.py").write_text("def read(ctx):\n    return 1.5\n")

    cell = cells.load_cell("nyuv2_train_b16", tmp_path / "BENCHMARK.json", bench)
    assert cell.traffic["batch"] == 16 and cell.limits == {"loss1_rel": 0.1}
    assert "gather_ms" in [m["name"] for m in cell.per_layer]
    assert cells.reader("gather_ms", bench)(None) == 1.5
    # the metric without a workloads list reaches every cell reporting its
    # end-to-end metric, and no serving cell
    serve = cells.load_cell("nyuv2_predict_b32", tmp_path / "BENCHMARK.json", bench)
    assert "gather_ms" not in [m["name"] for m in serve.per_layer]


def test_config_files_state_the_published_widths():
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        from benchmark.reference import model as ref_model

        assert ref_model.count_parameters(cfg) == cfg["parameters"]
        assert cfg["compute_dtype"] == "bfloat16"
    widths = {json.loads((ROOT / c["file"]).read_text())["name"]:
              (json.loads((ROOT / c["file"]).read_text())["num_subnetworks"],
               json.loads((ROOT / c["file"]).read_text())["filter_base_count"])
              for c in SPEC["configs"]}
    assert widths == {"nyuv2_depth_s2_f21": (2, 21), "nyuv2_depth_cli_s3_f32": (3, 32)}
    assert Path(cells.BENCH_DIR / "README.md").exists()
