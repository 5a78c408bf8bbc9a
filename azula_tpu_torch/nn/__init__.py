r"""Neural-network building blocks."""

from . import attention, dit, embedding, layers, utils, vit  # noqa: F401
