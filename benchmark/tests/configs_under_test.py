r"""The benchmark's configuration and reference modules, imported by file as
the harness imports them."""

from __future__ import annotations

from conftest import BENCH
from harness.manifest import load_module


def configuration(name: str):
    load_module(BENCH / "reference" / f"{name}.py", f"reference.{name}")
    return load_module(BENCH / "configs" / f"{name}.py", f"bench_config_{name}")


def reference(name: str):
    return load_module(BENCH / "reference" / f"{name}.py", f"reference.{name}")
