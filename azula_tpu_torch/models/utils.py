r"""Model-zoo helpers: the `cards.yaml` registry of each model family, the
checkpoint manifests (`manifests/<family>/<card>.<component>.json`, the
expected key -> shape map of each checkpoint component), the conversion of
JAX parameter arrays by name, and a seeded stand-in for a tokenizer."""

from __future__ import annotations

__all__ = [
    "SeededTokenizer",
    "check_manifest",
    "from_jax_arrays",
    "load_cards",
]

import json
import numpy as np
import os
import sys
import torch
import yaml
import zlib

from collections.abc import Callable, Mapping, Sequence
from types import ModuleType, SimpleNamespace

from ..nn.convert import check_state_dict, convert_leaf


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


def _manifest_dir() -> str:
    return os.path.join(os.path.dirname(__file__), "manifests")


def check_manifest(
    state_dict: Mapping,
    family: str,
    card: str,
    component: str,
    canonicalize: Callable[[dict], dict] | None = None,
) -> None:
    r"""Diffs a state dict (a checkpoint's, or a port module's) against the
    card's key -> shape manifest, after the family's key canonicalization,
    so that a wrong or drifted checkpoint fails with a named diff instead of
    a silent mis-load.

    Arguments:
        state_dict: Names -> tensors (anything with a `shape`).
        family: The model family (`'adm'`, `'flux'`, `'sana'`).
        card: The card name.
        component: The checkpoint component (`'vae'`, `'transformer'`, ...).
        canonicalize: The family's key canonicalization, applied to the names
            before the diff (the manifests are in canonical key space).

    Raises:
        ValueError: On missing keys, unexpected keys, or shape mismatches. A
        missing manifest file is not an error.
    """

    path = os.path.join(_manifest_dir(), family, f"{card}.{component}.json")
    if not os.path.exists(path):
        return

    with open(path) as f:
        manifest = {k: (None if v is None else tuple(v)) for k, v in json.load(f).items()}

    shapes = {k: tuple(int(d) for d in v.shape) for k, v in state_dict.items()}
    if canonicalize is not None:
        shapes = canonicalize(shapes)

    missing = sorted(set(manifest) - set(shapes))
    unexpected = sorted(set(shapes) - set(manifest))

    def matches(got: tuple, want: tuple) -> bool:
        # trailing singleton dimensions are tolerated (1x1 convs stored as linears)
        while len(got) > len(want) and got[-1] == 1:
            got = got[:-1]
        return got == want

    mismatched = [
        f"{k}: got {shapes[k]}, expected {want}"
        for k, want in manifest.items()
        if want is not None and k in shapes and not matches(shapes[k], want)
    ]

    if missing or unexpected or mismatched:
        parts = []
        if missing:
            parts.append(f"missing keys ({len(missing)}): {missing[:8]}")
        if unexpected:
            parts.append(f"unexpected keys ({len(unexpected)}): {unexpected[:8]}")
        if mismatched:
            parts.append(f"shape mismatches ({len(mismatched)}): {mismatched[:8]}")
        raise ValueError(
            f"state dict does not match the '{family}/{card}' {component} manifest:\n  " + "\n  ".join(parts)
        )


def from_jax_arrays(
    sd: Mapping[str, np.ndarray],
    module: torch.nn.Module | None = None,
    rename: Callable[[str], str] | None = None,
    tables: Sequence[str] = (),
    raw: Sequence[str] = (),
) -> dict[str, torch.Tensor]:
    r"""Converts the flat state dict of a JAX model-zoo module (numpy arrays,
    keys as `azula_tpu.utils.pytree.state_dict` yields them) to the port's
    layout: `rename` maps each key first; a norm's `scale` becomes `weight`;
    the arrays named in `tables` (embedding tables) become `<name>.weight`
    and those in `raw` are copied as they are; every other leaf is a Linear,
    convolution or bias (:func:`~azula_tpu_torch.nn.convert.convert_leaf`).

    Arguments:
        sd: The JAX state dict.
        module: Optionally, the port's module; when given, the result is held
            to it by :func:`~azula_tpu_torch.nn.convert.check_state_dict`.
        rename: A key map, applied before the rules above.
        tables: Leaf names of embedding tables.
        raw: Leaf names of arrays copied as they are.

    Returns:
        The port's state dict, as CPU tensors of the arrays' dtypes.
    """

    out = {}
    for key, value in sd.items():
        value = np.asarray(value)
        key = rename(key) if rename else key
        prefix, _, leaf = key.rpartition(".")
        if leaf in tables:
            key = f"{key}.weight"
        elif leaf in raw:
            pass
        elif leaf == "scale" and value.ndim == 1:
            key = f"{prefix}.weight"
        else:
            key, value = convert_leaf(key, value)
        out[key] = torch.from_numpy(np.ascontiguousarray(value).reshape(value.shape))  # keeps 0-d arrays 0-d

    if module is not None:
        check_state_dict(out, module)

    return out


class SeededTokenizer:
    r"""A stand-in for a checkpoint's tokenizer, for runs without tokenizer
    files: it turns each text into ids drawn from a generator seeded by the
    text (one id per 4 characters, at least one), between the special ids,
    with the call signature and outputs of a `transformers` tokenizer
    (`input_ids` and `attention_mask` as numpy arrays). The same text gives
    the same ids; a real tokenizer replaces it once its files ship.

    Arguments:
        vocab_size: The vocabulary size; the drawn ids avoid the special ids.
        model_max_length: The default length of `max_length` padding.
        bos: The id prepended (None for none).
        eos: The id appended (None for none).
        pad: The padding id.
        seed: Mixed into every text's seed.
    """

    def __init__(
        self,
        vocab_size: int,
        model_max_length: int,
        bos: int | None = None,
        eos: int | None = None,
        pad: int = 0,
        seed: int = 0,
    ) -> None:
        self.vocab_size = vocab_size
        self.model_max_length = model_max_length
        self.bos, self.eos, self.pad = bos, eos, pad
        self.seed = seed
        self.padding_side = "right"

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        special = {self.bos, self.eos, self.pad} - {None}
        rng = np.random.default_rng([self.seed, zlib.crc32(text.encode())])
        n = max(1, -(-len(text) // 4))
        ids = rng.integers(0, self.vocab_size - len(special), n)
        for s in sorted(special):  # skip the special ids
            ids = ids + (ids >= s)
        ids = [int(i) for i in ids]
        if add_special_tokens:
            ids = ([self.bos] if self.bos is not None else []) + ids + ([self.eos] if self.eos is not None else [])
        return ids

    def __call__(
        self,
        texts: str | Sequence[str],
        add_special_tokens: bool = True,
        truncation: bool = False,
        max_length: int | None = None,
        padding: str | bool = False,
        return_tensors: str | None = None,
    ) -> SimpleNamespace:
        if isinstance(texts, str):
            texts = [texts]
        max_length = self.model_max_length if max_length is None else max_length

        rows = [self.encode(text, add_special_tokens) for text in texts]
        if truncation:
            rows = [ids[:max_length] for ids in rows]
        width = max_length if padding == "max_length" else max(map(len, rows))

        input_ids = np.full((len(rows), width), self.pad, dtype=np.int64)
        attention_mask = np.zeros((len(rows), width), dtype=np.int64)
        for i, ids in enumerate(rows):
            input_ids[i, : len(ids)] = ids
            attention_mask[i, : len(ids)] = 1

        return SimpleNamespace(input_ids=input_ids, attention_mask=attention_mask)
