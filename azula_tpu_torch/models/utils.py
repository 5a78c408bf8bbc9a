r"""Model-zoo helpers: the `cards.yaml` registry of each model family, the
checkpoint manifests (`manifests/<family>/<card>.<component>.json`, the
expected key -> shape map of each checkpoint component) and their
generation, the reading of safetensors checkpoints, the digests that pin a
loaded model's numerics, the conversion of JAX parameter arrays by name, and
a seeded stand-in for a tokenizer."""

from __future__ import annotations

__all__ = [
    "SeededTokenizer",
    "activation_digest",
    "check_manifest",
    "compare_digests",
    "from_jax_arrays",
    "generate_manifests",
    "load_cards",
    "load_device",
    "load_hub_safetensors",
    "load_safetensors",
    "load_weights",
    "weight_digest",
]

import importlib
import itertools
import json
import math
import numpy as np
import os
import struct
import sys
import torch
import yaml
import zlib

from collections.abc import Callable, Mapping, Sequence
from types import ModuleType, SimpleNamespace

from ..nn.convert import check_state_dict, convert_leaf
from ..nn.utils import default_device


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


# safetensors dtype names -> torch dtypes
_SAFETENSORS_DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}


def load_safetensors(path: str | os.PathLike) -> dict[str, torch.Tensor]:
    r"""Reads a safetensors file into CPU tensors, memory-mapped.

    The format is an 8-byte little-endian header length, a JSON header
    mapping each name to its `dtype`, `shape` and `data_offsets` (from the end
    of the header), and the raw little-endian bytes. The file is mapped
    privately (copy on write): a tensor reads its pages when first used. A
    tensor whose offset is not a multiple of its item size is copied.

    Arguments:
        path: The file.

    Returns:
        A flat name-to-tensor mapping, in the file's order.
    """

    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))

    header.pop("__metadata__", None)

    size = os.path.getsize(path)
    data = torch.empty(0, dtype=torch.uint8)
    if size > 0:
        data.set_(torch.UntypedStorage.from_file(os.fspath(path), shared=False, nbytes=size))

    out = {}
    for name, info in header.items():
        if info["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor '{name}' has the unsupported dtype {info['dtype']}")

        dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        raw = data[8 + n + begin : 8 + n + end]

        itemsize = torch.empty((), dtype=dtype).element_size()
        if (8 + n + begin) % itemsize:
            raw = raw.clone()

        out[name] = raw.view(dtype).reshape(info["shape"])

    return out


def load_hub_safetensors(repo: str, name: str, variant: str | None = None) -> dict[str, torch.Tensor]:
    r"""Downloads and reads a (possibly sharded) safetensors checkpoint of a
    HuggingFace repository.

    A single-file checkpoint lives at `{name}{.variant}.safetensors`; a
    sharded one publishes `{name}{.variant}.safetensors.index.json`, whose
    `weight_map` names the shard files, next to it (tried when the single
    file answers 404).

    Arguments:
        repo: The repository (e.g. `'black-forest-labs/FLUX.1-dev'`).
        name: The checkpoint path inside the repository, without extension
            (e.g. `'transformer/diffusion_pytorch_model'`).
        variant: An optional variant infix (e.g. `'fp16'`).

    Returns:
        A flat name-to-tensor mapping (CPU tensors, memory-mapped).
    """

    import urllib.error

    from ..hub import download

    suffix = f".{variant}.safetensors" if variant else ".safetensors"
    base = f"https://huggingface.co/{repo}/resolve/main"

    try:
        return load_safetensors(download(f"{base}/{name}{suffix}"))
    except urllib.error.HTTPError as e:
        if e.code != 404:
            raise

    with open(download(f"{base}/{name}{suffix}.index.json")) as f:
        index = json.load(f)

    # the shards lie next to the index (at the root when `name` has no folder)
    folder, sep, _ = name.rpartition("/")

    out = {}
    for shard in sorted(set(index["weight_map"].values())):
        out.update(load_safetensors(download(f"{base}/{folder}{sep}{shard}")))

    return out


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


def load_device(device=None) -> torch.device:
    r"""The device a `load_model` places its modules on: the card unless the
    caller names another device. Without a CUDA device and without `device`,
    it raises rather than load onto the CPU."""

    device = default_device(device)

    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: load_model places the model on the card unless `device` names another")

    return device


def _trailing(shape) -> tuple[int, ...]:
    shape = tuple(shape)
    while shape and shape[-1] == 1:
        shape = shape[:-1]
    return shape


def load_weights(
    module: torch.nn.Module,
    state_dict: Mapping[str, torch.Tensor],
    canonicalize: Callable[[dict], dict] | None = None,
    device=None,
    dtype: torch.dtype | None = None,
) -> torch.nn.Module:
    r"""Fills a module built by :func:`~azula_tpu_torch.nn.utils.skip_init`
    with a checkpoint's tensors, in place.

    The checkpoint's names go through `canonicalize` (the family's key
    canonicalization) and are matched to the module's names, which the same
    canonicalization maps to the same space. A tensor whose shape differs
    from its parameter's by trailing singleton dimensions (a 1 x 1
    convolution stored for a Linear, a gain stored as (1,)) is reshaped. Each
    tensor is then moved to `device` and its floating values cast to `dtype`,
    one at a time, and the whole is assigned by
    `load_state_dict(strict=True, assign=True)`: no other copy of the
    parameters is made. Last, the module's other tensors (the tables built on
    the CPU) are moved to `device`.

    Arguments:
        module: The module, on the meta device.
        state_dict: The checkpoint's names -> tensors.
        canonicalize: The family's key canonicalization, or None.
        device: The target device. Defaults to where the tensors are.
        dtype: The target dtype of floating tensors. Defaults to the file's.

    Returns:
        The module.

    Raises:
        RuntimeError: On missing or unexpected keys, or on a tensor left
        without storage.
    """

    targets = module.state_dict()

    names = {name: name for name in targets}
    if canonicalize is not None:
        names = canonicalize(names)
        state_dict = canonicalize(state_dict)

    loaded = {}
    for key, tensor in state_dict.items():
        name = names.get(key, key)
        target = targets.get(name)
        if target is not None and tensor.shape != target.shape and _trailing(tensor.shape) == _trailing(target.shape):
            tensor = tensor.reshape(target.shape)
        cast = dtype if tensor.is_floating_point() else None
        loaded[name] = tensor.to(device=device, dtype=cast).contiguous()

    module.load_state_dict(loaded, strict=True, assign=True)

    if device is not None:
        module.to(device)

    empty = [name for name, t in itertools.chain(module.named_parameters(), module.named_buffers()) if t.is_meta]
    if empty:
        raise RuntimeError(f"tensors left without storage after loading: {empty[:8]}")

    return module


def generate_manifests(family: str, out_dir: str | None = None) -> list[str]:
    r"""Writes the key -> shape manifests of one model family, from the state
    dicts of the port's modules built on the meta device (the port's keys are
    the checkpoints'; the text encoders' and the VAE's go through their key
    canonicalization).

    Arguments:
        family: `'adm'`, `'vdm'`, `'jit'`, `'sd'`, `'flux'` or `'sana'`.
        out_dir: The manifest root. Defaults to the packaged `manifests/`.

    Returns:
        The paths written.
    """

    out_dir = out_dir or _manifest_dir()
    written = []
    meta = torch.device("meta")

    def write(card: str, component: str, module: torch.nn.Module, canonicalize=None) -> None:
        shapes = {k: list(v.shape) for k, v in module.state_dict().items()}
        if canonicalize is not None:
            shapes = canonicalize(shapes)

        path = os.path.join(out_dir, family, f"{card}.{component}.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(dict(sorted(shapes.items())), f, indent=0)
            f.write("\n")
        written.append(path)

    if family in ("adm", "vdm", "jit"):
        plugin = importlib.import_module(f"{__package__}.{family}")
        canonicalize = plugin.canonicalize_adm_keys if family == "adm" else None
        for card, entry in load_cards(plugin).items():
            write(card, "model", plugin.make_model(**entry.config, device=meta).backbone, canonicalize)

    elif family == "sd":
        from . import autoencoder, clip, sd
        from .sd import backbone

        for card in load_cards(sd):
            arch = sd._arch(card)
            write(card, "unet", backbone.SDUNet(**arch["unet"], device=meta))
            write(card, "vae", autoencoder.AutoencoderKL(device=meta), autoencoder.canonicalize_vae_keys)
            write(card, "text_encoder", clip.CLIPTextEncoder(**arch["clip"], device=meta), clip.canonicalize_clip_keys)

    elif family == "flux":
        from . import autoencoder, clip, flux, t5
        from .flux import backbone

        for card in load_cards(flux):
            transformer = backbone.FluxTransformer(guidance_embeds="schnell" not in card, device=meta)
            write(card, "transformer", transformer)
            vae = autoencoder.AutoencoderKL(latent_channels=16, use_quant_conv=False, device=meta)
            write(card, "vae", vae, autoencoder.canonicalize_vae_keys)
            write(card, "text_encoder", clip.CLIPTextEncoder(device=meta), clip.canonicalize_clip_keys)
            write(card, "text_encoder_2", t5.T5Encoder(device=meta), t5.canonicalize_t5_keys)

    elif family == "sana":
        from . import gemma, sana
        from .sana import autoencoder as dcae

        for card in load_cards(sana):
            write(card, "transformer", sana.SanaTransformer(**sana._arch(card), device=meta))
            write(card, "vae", dcae.AutoencoderDC(device=meta))
            write(card, "text_encoder", gemma.Gemma2TextModel(device=meta), gemma.canonicalize_gemma_keys)

    else:
        raise ValueError(f"no manifest generator for family '{family}'")

    return written


def _jax_normal(key: tuple[int, int], shape: tuple[int, ...]) -> np.ndarray:
    r"""`jax.random.normal(key, shape, float32)` of JAX's default threefry
    generator (`jax_threefry_partitionable`), in numpy: the threefry-2x32
    hash of each flat index, a float32 uniform on :math:`(-1, 1)` from its 23
    high bits, then :math:`\sqrt 2 \,\mathrm{erf}^{-1}(u)` by the float32
    polynomial that XLA evaluates (Giles, 2010). The bits are JAX's; the
    values agree to an ulp or two (`log1p` differs)."""

    n = math.prod(shape)
    bits1, bits2 = _threefry2x32(key, np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32))
    bits = bits1 ^ bits2

    one = np.array(1.0, np.float32).view(np.uint32)
    floats = ((bits >> np.uint32(9)) | one).view(np.float32) - np.float32(1.0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    u = np.maximum(lo, floats * (np.float32(1.0) - lo) + lo)

    return (np.float32(math.sqrt(2)) * _erfinv32(u)).reshape(shape)


# Giles' single-precision erfinv: the polynomials in w = -log(1 - u^2) - 2.5
# (w < 5) and in sqrt(w) - 3 (w >= 5), highest degree first
_ERFINV_CENTRAL = (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
    -0.00125372503, -0.00417768164, 0.246640727, 1.50140941,
)
_ERFINV_TAIL = (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
    -0.0076224613, 0.00943887047, 1.00167406, 2.83297682,
)


def _erfinv32(u: np.ndarray) -> np.ndarray:
    w = -np.log1p(-u * u)
    central, tail = w - np.float32(2.5), np.sqrt(w) - np.float32(3.0)

    p, q = np.float32(_ERFINV_CENTRAL[0]), np.float32(_ERFINV_TAIL[0])
    for a, b in zip(_ERFINV_CENTRAL[1:], _ERFINV_TAIL[1:]):
        p = np.float32(a) + p * central
        q = np.float32(b) + q * tail

    return np.where(w < 5, p, q) * u


def _threefry2x32(key: tuple[int, int], x0: np.ndarray, x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    r"""The threefry-2x32 block cipher of JAX's generator (20 rounds)."""

    def rotl(v, d):
        return (v << np.uint32(d)) | (v >> np.uint32(32 - d))

    ks = [np.uint32(key[0]), np.uint32(key[1])]
    ks.append(ks[0] ^ ks[1] ^ np.uint32(0x1BD11BDA))
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))

    x0, x1 = x0 + ks[0], x1 + ks[1]
    for i in range(5):
        for r in rotations[i % 2]:
            x0 = x0 + x1
            x1 = rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)

    return x0, x1


def weight_digest(sd: Mapping, decimals: int = 5) -> dict:
    r"""Per-tensor statistics of a state dict (tensors or arrays): shape, and
    mean and standard deviation in float64, rounded.

    Complements :func:`check_manifest`: shapes catch missing or mis-mapped
    keys, the statistics transpositions, truncations and scalings.
    """

    out = {}
    for k in sorted(sd):
        v = sd[k]
        a = (v.detach().to("cpu", torch.float64).numpy() if isinstance(v, torch.Tensor) else np.asarray(v, dtype=np.float64))
        out[k] = {
            "shape": list(a.shape),
            "mean": round(float(a.mean()), decimals),
            "std": round(float(a.std()), decimals),
        }
    return out


def activation_digest(
    fn: Callable,
    shapes: Mapping[str, Sequence[int]],
    times: Sequence[float] = (0.1, 0.5, 0.9),
    decimals: int = 4,
) -> list[dict]:
    r"""End-to-end activation statistics of a denoiser on fixed probes: the
    port of :func:`azula_tpu.models.utils.activation_digest`, with the same
    probes.

    `fn(x_t, t)` is evaluated at a few times on one input drawn as the JAX
    package draws it (`jax.random.normal` of the first half of the split of
    key 0, float32, on the CPU); each record holds the output's mean,
    standard deviation, largest magnitude and 8 projections on the second
    half's normals, scaled by :math:`1 / \sqrt{n}`, rounded.

    Arguments:
        fn: The probed callable (typically `lambda x, t: denoiser(x, t).mean`).
        shapes: `{"x": (...)}`, the probe's (batched) shape.
        times: The times probed.
        decimals: The rounding.
    """

    shape = tuple(int(d) for d in shapes["x"])
    n = math.prod(shape)

    k_x, k_p = _threefry2x32((0, 0), np.zeros(2, np.uint32), np.arange(2, dtype=np.uint32))
    x = _jax_normal((int(k_x[0]), int(k_p[0])), shape)
    proj = _jax_normal((int(k_x[1]), int(k_p[1])), (8, n)) / np.float32(math.sqrt(n))

    x = torch.from_numpy(x)
    records = []
    for t in times:
        y = fn(x, torch.full(shape[:1], t, dtype=torch.float32))
        y = y.detach().to("cpu", torch.float64).numpy()
        p = proj.astype(np.float64) @ y.reshape(-1)
        records.append(
            {
                "t": t,
                "mean": round(float(y.mean()), decimals),
                "std": round(float(y.std()), decimals),
                "absmax": round(float(np.abs(y).max()), decimals),
                "proj": [round(float(v), decimals) for v in p],
            }
        )
    return records


def compare_digests(got: Mapping, want: Mapping, rtol: float = 1e-3, atol: float = 1e-3) -> list[str]:
    r"""The named differences between two digest documents (`weights` and
    `activations` sections); an empty list is a match."""

    diffs = []

    def close(a, b) -> bool:
        if isinstance(a, list) and isinstance(b, list):
            return len(a) == len(b) and all(close(x, y) for x, y in zip(a, b))
        if isinstance(a, (int, float)) and isinstance(b, (int, float)):
            return math.isclose(a, b, rel_tol=rtol, abs_tol=atol)
        return a == b

    for section in ("weights", "activations"):
        g, w = got.get(section), want.get(section)
        if (g is None) != (w is None):
            diffs.append(f"{section}: present in one digest only")
            continue
        if g is None:
            continue
        if section == "weights":
            for k in sorted(set(g) | set(w)):
                if k not in g or k not in w:
                    diffs.append(f"weights[{k}]: missing on one side")
                elif not all(close(g[k].get(f), w[k].get(f)) for f in ("shape", "mean", "std")):
                    diffs.append(f"weights[{k}]: {g[k]} != {w[k]}")
        else:
            for i, (a, b) in enumerate(zip(g, w)):
                for field in ("mean", "std", "absmax", "proj"):
                    if not close(a[field], b[field]):
                        diffs.append(f"activations[{i}].{field} (t={a.get('t')}): {a[field]} != {b[field]}")
            if len(g) != len(w):
                diffs.append(f"activations: {len(g)} records != {len(w)}")

    return diffs


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
