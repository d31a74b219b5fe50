"""Nothing the harness or the reference imports is JAX or the JAX package,
and nothing in the reference or the cost functions is the program (every
module's top-level name compared whole)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "ba_path_planning_tpu"}
PROGRAM = "ba_path_planning_torch"


def _imports(path):
    """Top-level names of the absolute imports of a source file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


HARNESS = sorted(p for p in ROOT.rglob("*.py") if "tests" not in p.parts)
REFERENCE = sorted((ROOT / "reference").glob("*.py"))


@pytest.mark.parametrize("path", HARNESS, ids=lambda p: p.name)
def test_no_jax_in_the_harness_sources(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    names = _imports(path)
    assert PROGRAM not in names and not names & FORBIDDEN
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.level:
            assert node.level == 1, "the reference imports only itself"


def _run(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT.parent,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_the_reference_loads_nothing_of_the_program():
    last = _run("import sys, port_bench.reference.scp, "
                "port_bench.reference.judge, port_bench.reference.cost; "
                "print(sorted({m.split('.')[0] for m in sys.modules}"
                f" & set({sorted(FORBIDDEN | {PROGRAM})!r})))")
    assert last == "[]"


def test_a_run_loads_no_jax():
    last = _run(
        "import sys, torch; torch.set_num_threads(1); "
        "sys.path.insert(0, 'port_bench/tests'); "
        "from helpers import small_cell; from port_bench import run; "
        "line, _ = run.run_cell(small_cell(), 5, 0.2, True, 'cpu'); "
        "print(run.forbidden_modules())")
    assert last == "[]"
