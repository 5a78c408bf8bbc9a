r"""Model-zoo helpers: the `cards.yaml` registry of each model family."""

from __future__ import annotations

__all__ = [
    "load_cards",
]

import os
import sys
import torch
import yaml

from types import ModuleType, SimpleNamespace


def _as_torch_dtype(name: str | None) -> torch.dtype | None:
    if name is None:
        return None

    dtype = getattr(torch, name, None)

    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"Unknown data type '{name}'.")

    return dtype


def load_cards(plugin: ModuleType | str) -> dict[str, SimpleNamespace]:
    r"""Returns the name-card mapping of the pretrained models listed in a model
    family's `cards.yaml`.

    Arguments:
        plugin: The model-family module (or its name).
    """

    if isinstance(plugin, str):
        plugin = sys.modules[plugin]

    file = os.path.join(os.path.dirname(plugin.__file__), "cards.yaml")

    if not os.path.exists(file):
        raise FileNotFoundError(f"{plugin.__name__} has no cards.yaml")

    with open(file) as f:
        cards = yaml.safe_load(f)

    for card in cards.values():
        if "dtype_map" in card:
            card["dtype_map"] = {k: _as_torch_dtype(v) for k, v in card["dtype_map"].items()}

    return {name: SimpleNamespace(**card) for name, card in cards.items()}
