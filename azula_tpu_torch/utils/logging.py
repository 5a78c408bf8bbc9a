r"""Structured logging.

Port of :mod:`azula_tpu.utils.logging`: a namespaced logger with a single-line
format carrying timestamps and levels, used by long-running entry points
(downloads, checkpoint loading). Loggers are named under `azula_tpu_torch`.
"""

from __future__ import annotations

__all__ = [
    "get_logger",
]

import logging
import sys

_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"


def get_logger(name: str = "azula_tpu_torch") -> logging.Logger:
    r"""Returns a logger under the package's, whose stderr handler is set up
    once."""

    logger = logging.getLogger(name)

    root = logging.getLogger("azula_tpu_torch")
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        root.propagate = False

    return logger
