"""What a run of the benchmark loads: no module whose top-level name is
``jax``, ``jaxlib``, ``flax`` or ``nmrf_tpu`` (compared whole: the
measured package's name, ``nmrf_tpu_torch``, begins with the last), and
nothing of the measured package under ``benchmark/reference``."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness
from benchmark.tests import tiny

PACKAGE = Path(harness.__file__).resolve().parent


def imported_roots(path):
    """Top-level names of every import statement in a Python file."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PACKAGE)))
def test_no_source_imports_jax(path):
    assert not imported_roots(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((PACKAGE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "nmrf_tpu_torch" not in imported_roots(path)
    assert imported_roots(path) <= {"math", "functools", "numpy", "torch",
                                    "benchmark"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "nmrf_tpu_torch_probe", sys)
    assert "nmrf_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "nmrf_tpu.sub", sys)
    assert harness.forbidden_modules() == ["nmrf_tpu"]


def test_a_run_loads_no_forbidden_module(tmp_path):
    """A whole rehearsal run in a fresh process: every module it loads,
    the measured package's included, read from ``sys.modules`` at its end."""
    root = tiny.write(tmp_path)
    code = ("import sys, json; from benchmark import run; "
            "run.main(sys.argv[1:]); "
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run(
        [sys.executable, "-c", code, "--workload", "tiny_stream", "--seed",
         "5", "--seconds", "0.5", "--device", "cpu", "--root", str(root)],
        cwd=tiny.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    roots = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "nmrf_tpu_torch" in roots
    assert not roots & set(harness.FORBIDDEN)
