"""What a run may load: no JAX and no JAX package, compared by whole
top-level names, and a reference that imports nothing of the program."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
REFERENCE = ROOT / "port_bench" / "reference"
PROGRAM = "gps_gaussian_tpu_torch"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(REFERENCE.glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_neither_jax_nor_the_program(path):
    from port_bench import harness

    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & set(harness.FORBIDDEN)
    assert PROGRAM not in tops


def test_forbidden_names_are_compared_whole():
    from port_bench import harness

    assert harness.forbidden_modules(
        ["gps_gaussian_tpu_torch", "gps_gaussian_tpu_torch.infer", "torch",
         "jaxtyping", "flaxen"]) == []
    assert harness.forbidden_modules(
        ["gps_gaussian_tpu.models", "jax.numpy", "jaxlib", "flax.linen",
         "numpy"]) == ["flax", "gps_gaussian_tpu", "jax", "jaxlib"]


def test_reference_alone_loads_no_program_module():
    code = ("import sys, json; sys.path.insert(0, %r)\n"
            "import port_bench.reference.pipeline\n"
            "import port_bench.roofline, port_bench.judge\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in "
            "sys.modules})))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "gps_gaussian_tpu", PROGRAM}


def test_a_whole_run_loads_no_jax(tmp_path):
    """A small run in a fresh process: nothing it executed loaded JAX or
    the JAX package (run.py itself exits 3 when it finds one)."""
    code = (
        "import sys, json; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "from pathlib import Path\n"
        "from conftest import write_small, run_small\n"
        "from port_bench import harness\n"
        "bench = write_small(Path(%r))\n"
        "out = run_small((bench, Path(%r)), 'serve-seq-1view', 5)\n"
        "print(json.dumps({'found': harness.forbidden_modules(), "
        "'correct': out['correct']}))"
        % (str(ROOT), str(ROOT / "port_bench" / "tests"), str(tmp_path),
           str(tmp_path)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"found": [], "correct": True}
