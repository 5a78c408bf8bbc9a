r"""Neural-network building blocks."""

from . import attention, dit, embedding, layers, unet, utils, vit  # noqa: F401
