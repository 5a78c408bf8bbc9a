r"""The kernel library's C entry points against the argument lists that
`ops/_build.py` gives ctypes, on the CPU: each `extern "C"` declaration in
`azula_tpu_torch/csrc/*.cu`, parsed from the source, takes the pointers,
ints and floats of `_SIGNATURES[name]` in that order, and every entry that
returns a status has its list. A list that drifts from its declaration
passes the wrong arguments on the card without any error, so the sources
are held to it here, where nothing is built.
"""

import ctypes
import re

import pytest

from azula_tpu_torch.ops import _build

_DECLARATION = re.compile(r'extern "C" int (azula_\w+)\(([^)]*)\)', re.MULTILINE)


def _kind(parameter: str):
    r"""The ctypes type of one C parameter: a pointer, an int or a float."""

    if "*" in parameter:
        return ctypes.c_void_p
    if re.match(r"^(const )?int \w+$", parameter):
        return ctypes.c_int
    if re.match(r"^(const )?float \w+$", parameter):
        return ctypes.c_float
    raise AssertionError(f"unexpected C parameter {parameter!r}")


def _declarations() -> dict[str, list]:
    found = {}
    for path in _build._sources():
        for name, parameters in _DECLARATION.findall(path.read_text()):
            parameters = " ".join(parameters.split())
            kinds = [_kind(p.strip()) for p in parameters.split(",")] if parameters else []
            assert name not in found, f"{name} is declared twice"
            found[name] = kinds
    return found


DECLARATIONS = _declarations()


def test_every_entry_has_its_argument_list():
    assert sorted(DECLARATIONS) == sorted(_build._SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_argument_list_matches_the_declaration(name):
    assert DECLARATIONS[name] == _build._SIGNATURES[name]
