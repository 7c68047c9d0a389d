"""What the benchmark may import: no JAX, no JAX package, none of the
repository's JAX-era tooling; and a reference that imports nothing of the
program.  Checked from the sources and from the modules a run loads."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from benchmark import cells

BENCH = cells.BENCH_DIR
FORBIDDEN = {"jax", "jaxlib", "flax", "mimo_unet_tpu", "chip_smoke", "tools", "bench"}


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def sources(*dirs):
    return [p for d in dirs for p in sorted(d.rglob("*.py")) if "tests" not in p.parts]


def test_no_benchmark_source_imports_jax_or_the_jax_package():
    for path in sources(BENCH):
        bad = set(top_level_imports(path)) & FORBIDDEN
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_program():
    for path in sources(BENCH / "reference"):
        assert "mimo_unet_torch" not in set(top_level_imports(path)), path


def test_the_harness_names_the_same_forbidden_modules():
    from benchmark import run

    assert set(run.FORBIDDEN) == FORBIDDEN


SNIPPET = """
import json, sys
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(body: str):
    out = subprocess.run([sys.executable, "-c", SNIPPET.format(root=str(cells.ROOT), body=body)],
                         capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_cpu_run_loads_no_forbidden_module():
    body = (
        "import torch; torch.set_num_threads(2)\n"
        "from benchmark.tests.tiny import tiny_cell\n"
        "from benchmark.run import run_cell\n"
        "run_cell(tiny_cell('train'), 5, 0.2, False, 'cpu')\n"
        "run_cell(tiny_cell('serve'), 5, 0.2, True, 'cpu')\n")
    mods = loaded(body)
    assert "mimo_unet_torch" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    body = ("import benchmark.reference.model, benchmark.reference.train, "
            "benchmark.reference.quant, benchmark.yardstick, benchmark.inputs")
    mods = loaded(body)
    assert "mimo_unet_torch" not in mods and not mods & FORBIDDEN
