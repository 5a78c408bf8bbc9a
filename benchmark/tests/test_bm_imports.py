r"""Nothing of the benchmark imports JAX or the JAX package, and the plain
references import nothing of the program. Top-level module names are
compared whole: `azula_tpu_torch` is not `azula_tpu`."""

from __future__ import annotations

import ast
import sys

import pytest

from conftest import BENCH
from harness import runner

FORBIDDEN = {"jax", "jaxlib", "flax", "azula_tpu"}


def imported(path) -> set[str]:
    r"""The top-level names of the modules that the file `path` imports."""

    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(node.args[0].value.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_imports_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert not any(name.startswith("azula") for name in imported(path))
    assert imported(path) <= {"__future__", "math", "torch", "reference"}


def test_the_port_is_not_the_jax_package(monkeypatch):
    monkeypatch.setitem(sys.modules, "azula_tpu_torch_probe", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_probe", object())
    assert not {"azula_tpu_torch_probe", "jaxtyping_probe"} & set(runner.forbidden_modules())
    monkeypatch.setitem(sys.modules, "azula_tpu.probe", object())
    monkeypatch.setitem(sys.modules, "jax.probe", object())
    assert {"azula_tpu.probe", "jax.probe"} <= set(runner.forbidden_modules())


def test_a_cpu_run_imports_no_jax(tiny_root):
    r"""What a run of the harness imports, in a fresh process."""

    import subprocess

    code = (
        "import sys, time, torch; sys.path[:0] = [sys.argv[1] + '/benchmark', sys.argv[2]];"
        "from harness import manifest, runner;"
        "cell = manifest.cell(__import__('pathlib').Path(sys.argv[1]), 'tiny_flux.ddim3_b2');"
        "runner.run(cell, 1, 0.01, False, torch.device('cpu'), time.perf_counter());"
        "print(runner.forbidden_modules())"
    )
    out = subprocess.run(
        [sys.executable, "-c", code, str(tiny_root), str(BENCH.parent)],
        capture_output=True, text=True, timeout=600, check=True,
    )
    assert out.stdout.strip().splitlines()[-1] == "[]"
