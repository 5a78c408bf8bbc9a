r"""Neural-network building blocks."""

from . import layers, utils  # noqa: F401
