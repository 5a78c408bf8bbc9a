r"""Debug helpers.

Port of :mod:`azula_tpu.debug` (`RaiseMock`): an error-raising proxy for
optional dependencies, so that a missing extra fails loudly at use time
instead of import time.
"""

from __future__ import annotations

__all__ = [
    "RaiseMock",
]


class RaiseMock:
    r"""An object that raises an error when used in any way.

    Arguments:
        name: The name of the mocked object.
        error: The exception to raise on use.
    """

    def __init__(self, name: str, error: Exception) -> None:
        self._name = name
        self._error = error

    def _raise(self):
        raise RuntimeError(f"'{self._name}' is unavailable") from self._error

    def __call__(self, *args, **kwargs):
        self._raise()

    def __getattr__(self, attr: str):
        if attr.startswith("_"):
            return super().__getattribute__(attr)
        self._raise()

    def __repr__(self) -> str:
        return f"RaiseMock({self._name})"
