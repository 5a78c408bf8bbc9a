r"""The PyTorch port's hub and checkpoint readers (`azula_tpu_torch.hub`,
`azula_tpu_torch.models.ptread`, the safetensors reader of
`azula_tpu_torch.models.utils`) against the JAX package's, on the CPU.

Downloads go over `file://` URLs, as in `tests/test_hub.py`: the whole
download, verify and extract path runs without the network. The same bytes
go through both packages' readers and come out equal, bit for bit; both
accept and refuse the same globals.
"""

import argparse
import hashlib
import io
import json
import numpy as np
import os
import pickle
import pickletools
import pytest
import tarfile
import torch
import urllib.error
import urllib.request
import zipfile

import azula_tpu.hub as jhub
import azula_tpu.models.ptread as jptread
import azula_tpu.models.utils as jutils
import azula_tpu_torch.hub as thub
import azula_tpu_torch.models.ptread as tptread
import azula_tpu_torch.models.utils as tutils


@pytest.fixture
def hubs(tmp_path, monkeypatch):
    monkeypatch.setattr(thub, "_HUB_DIR", tmp_path / "hub")
    monkeypatch.setattr(jhub, "_HUB_DIR", tmp_path / "jax_hub")
    return tmp_path


def _source(tmp_path, content=b"hello azula", name="payload.bin"):
    src = tmp_path / "src" / name
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_bytes(content)
    return src, f"file://{src}"


# ------------------------------------------------------------------------ hub


def test_download_and_cache(hubs):
    src, url = _source(hubs)

    path = thub.download(url, quiet=True)
    assert path.read_bytes() == b"hello azula" and path.parent == thub.get_hub_dir()
    assert path.name == thub.cache_name(url)
    assert not list(path.parent.glob("*.part"))

    # a second call is served by the cache
    src.unlink()
    assert thub.download(url, quiet=True) == path


def test_default_hub_dir(monkeypatch, tmp_path):
    monkeypatch.setattr(thub, "_HUB_DIR", None)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert thub.get_hub_dir() == tmp_path / ".cache" / "azula_tpu_torch" / "hub"
    thub.set_hub_dir(tmp_path / "elsewhere")
    assert thub.get_hub_dir() == tmp_path / "elsewhere"


def test_hash_verification(hubs):
    _, url = _source(hubs)
    digest = hashlib.sha256(b"hello azula").hexdigest()

    thub.download(url, quiet=True, hash_prefix=f"sha256:{digest[:16]}")
    thub.download(url, quiet=True, hash_prefix=f"md5:{hashlib.md5(b'hello azula').hexdigest()[:8]}")

    for pkg in (thub, jhub):
        with pytest.raises(RuntimeError, match="hash mismatch"):
            pkg.download(url, quiet=True, hash_prefix="sha256:deadbeef")


@pytest.mark.parametrize("kind", ["tar", "zip"])
def test_extract(hubs, kind):
    inner = hubs / "inner.txt"
    inner.write_text("payload")

    archive = hubs / f"archive.{kind}"
    if kind == "tar":
        with tarfile.open(archive, "w") as tar:
            tar.add(inner, arcname="dir/inner.txt")
    else:
        with zipfile.ZipFile(archive, "w") as zf:
            zf.write(inner, arcname="dir/inner.txt")

    for pkg in (thub, jhub):
        out = pkg.download(f"file://{archive}", quiet=True, extract=True)
        assert out.name.endswith("+x")
        assert (out / "dir" / "inner.txt").read_text() == "payload"

    _, url = _source(hubs, b"not an archive")
    with pytest.raises(RuntimeError, match="not a recognized archive"):
        thub.download(url, quiet=True, extract=True)


def test_tar_members_stay_inside(hubs):
    r"""Extraction filters members as `filter="data"` does: a member that
    climbs out of the directory is refused."""

    archive = hubs / "evil.tar"
    with tarfile.open(archive, "w") as tar:
        info = tarfile.TarInfo("../escaped.txt")
        info.size = 3
        tar.addfile(info, io.BytesIO(b"bad"))

    with pytest.raises(tarfile.TarError):
        thub.download(f"file://{archive}", quiet=True, extract=True)
    assert not (thub.get_hub_dir() / "escaped.txt").exists()


def test_a_failed_download_leaves_no_file(hubs, monkeypatch):
    def broken(url):
        raise urllib.error.URLError("unreachable")

    monkeypatch.setattr(urllib.request, "urlopen", broken)
    with pytest.raises(urllib.error.URLError):
        thub.download("https://example.invalid/model.pt", quiet=True)
    assert not list(thub.get_hub_dir().iterdir())


def test_urls_sharing_a_basename_get_two_files(hubs):
    r"""The JAX package names a cached file after the URL's basename, so the
    `unet/` and `vae/` files of one repository share a file and the second
    download returns the first's bytes; the port names it after the whole
    URL."""

    unet, unet_url = _source(hubs, b"the unet", "repo/unet/diffusion_pytorch_model.fp16.safetensors")
    vae, vae_url = _source(hubs, b"the vae", "repo/vae/diffusion_pytorch_model.fp16.safetensors")

    assert jhub.download(unet_url, quiet=True).read_bytes() == b"the unet"
    assert jhub.download(vae_url, quiet=True).read_bytes() == b"the unet"

    a, b = thub.download(unet_url, quiet=True), thub.download(vae_url, quiet=True)
    assert a != b and a.read_bytes() == b"the unet" and b.read_bytes() == b"the vae"

    # and across repositories and queries
    names = {
        thub.cache_name(u)
        for u in (
            "https://huggingface.co/black-forest-labs/FLUX.1-dev/resolve/main/vae/diffusion_pytorch_model.safetensors",
            "https://huggingface.co/stabilityai/sd-vae-ft-mse/resolve/main/diffusion_pytorch_model.safetensors",
            "https://www.dropbox.com/scl/fo/x/jit-b-16?rlkey=a&dl=1",
            "https://www.dropbox.com/scl/fo/x/jit-b-16?rlkey=b&dl=1",
        )
    }
    assert len(names) == 4 and all(len(n) <= 255 for n in names)
    assert len(thub.cache_name("https://h/" + "x" * 400)) <= 255


# ------------------------------------------------------------------- load_pt


def _tensors() -> dict:
    g = torch.Generator().manual_seed(0)
    t = torch.randn(4, 6, generator=g)
    shared = torch.arange(10.0)
    return {
        "f32": t,
        "f32_t": t.t(),  # a view of shared storage, not contiguous
        "slice": shared[2:7],  # a view at an offset
        "f16": torch.randn(3, 5, generator=g).half(),
        "bf16": torch.randn(3, 5, generator=g).bfloat16(),
        "i64": torch.randint(-(2**40), 2**40, (7,), generator=g),
        "scalar": torch.tensor(3.5),
        "nested": {"a": [torch.ones(2), 7, "s", 1.5, None, (1, 2)]},
    }


def _equal(ours, theirs, name="root") -> None:
    if isinstance(theirs, np.ndarray) and not isinstance(ours, torch.Tensor):
        assert isinstance(ours, np.ndarray) and ours.dtype == theirs.dtype and np.array_equal(ours, theirs), name
    elif isinstance(theirs, np.ndarray):  # a tensor read by JAX's reader
        assert tuple(ours.shape) == theirs.shape, name
        if ours.dtype == torch.bfloat16:
            ours, theirs = ours.float(), theirs.astype(np.float32)
        assert str(ours.dtype).removeprefix("torch.") == str(theirs.dtype), name
        assert np.array_equal(ours.numpy(), theirs), name
    elif isinstance(theirs, dict):
        assert set(ours) == set(theirs), name
        for k in theirs:
            _equal(ours[k], theirs[k], f"{name}.{k}")
    elif isinstance(theirs, (list, tuple)):
        assert type(ours) is type(theirs) and len(ours) == len(theirs), name
        for i, (a, b) in enumerate(zip(ours, theirs)):
            _equal(a, b, f"{name}[{i}]")
    else:
        assert type(ours) is type(theirs) and ours == theirs, name


@pytest.mark.parametrize("legacy", [False, True], ids=["zip", "legacy"])
def test_load_pt_against_jax(legacy, tmp_path):
    sd = _tensors()
    path = tmp_path / "ckpt.pt"
    torch.save(sd, path, _use_new_zipfile_serialization=not legacy)

    ours = tptread.load_pt(path)
    _equal(ours, jptread.load_pt(str(path)))

    # and what torch itself reads, views and all
    for key in ("f32", "f32_t", "slice", "f16", "bf16", "i64", "scalar"):
        assert ours[key].dtype == sd[key].dtype and torch.equal(ours[key], sd[key]), key
    assert ours["f32_t"].stride() == sd["f32_t"].stride()

    # from an open file too
    with open(path, "rb") as f:
        _equal(tptread.load_pt(f), jptread.load_pt(str(path)))


@pytest.mark.parametrize("legacy", [False, True], ids=["zip", "legacy"])
def test_load_pt_accepts_numpy(legacy, tmp_path):
    r"""Numpy scalars, arrays and dtypes, which `torch.load(weights_only=True)`
    refuses by itself, are admitted as the JAX reader admits them."""

    obj = {
        "step": np.int64(5),
        "lr": np.float32(2.5e-4),
        "array": np.arange(6.0).reshape(2, 3),
        "ints": np.arange(4, dtype=np.int16),
        "dtype": np.dtype("float16"),
        "w": torch.ones(3),
    }
    path = tmp_path / "np.pt"
    torch.save(obj, path, _use_new_zipfile_serialization=not legacy)

    with pytest.raises(pickle.UnpicklingError):
        torch.load(path, weights_only=True)

    ours, theirs = tptread.load_pt(path), jptread.load_pt(str(path))
    for key in ("step", "lr", "array", "ints"):
        assert type(ours[key]) is type(theirs[key]) is type(obj[key])
        assert np.array_equal(ours[key], obj[key]) and np.array_equal(theirs[key], obj[key])
    assert ours["dtype"] == theirs["dtype"] == np.dtype("float16")


def _short(s: str) -> bytes:
    data = s.encode()
    return b"X" + len(data).to_bytes(4, "little") + data


# object pickles that `torch.save` does not write: a STACK_GLOBAL whose names
# sit below two popped ones (resolves `torch.device`), and a storage name
# under another module than `torch`
_CRAFTED = {
    "stack-global-after-pops": b"\x80\x04"
    + _short("torch")
    + _short("device")
    + _short("torch")
    + _short("Size")
    + b"00\x93"
    + _short("cpu")
    + b"\x85R.",
    "foreign-storage-name": b"\x80\x02cos\nFloatStorage\n.",
}


def _write_crafted(path, pickled: bytes, legacy: bool) -> None:
    r"""A checkpoint of either format whose object pickle is `pickled`."""

    if legacy:
        buffer = io.BytesIO()
        torch.save({}, buffer, _use_new_zipfile_serialization=False)
        buffer.seek(0)
        for _ in range(3):  # magic number, protocol, system info
            for _ in pickletools.genops(buffer):
                pass
        path.write_bytes(buffer.getvalue()[: buffer.tell()] + pickled + pickle.dumps([], protocol=2))
    else:
        torch.save({}, path.with_suffix(".src"))
        reader = torch._C.PyTorchFileReader(str(path.with_suffix(".src")))
        writer = torch._C.PyTorchFileWriter(str(path))
        for name in reader.get_all_records():
            data = pickled if name.endswith("data.pkl") else reader.get_record(name)
            writer.write_record(name, data, len(data))
        writer.write_end_of_file()


@pytest.mark.parametrize(
    "evil",
    [argparse.Namespace(lr=1e-4), os.system, print, torch.device("cpu"), torch.float32, {1, 2}.__class__, *_CRAFTED],
    ids=["namespace", "os.system", "print", "torch.device", "torch.dtype", "set-type", *_CRAFTED],
)
@pytest.mark.parametrize("legacy", [False, True], ids=["zip", "legacy"])
def test_load_pt_refuses_what_jax_refuses(evil, legacy, tmp_path):
    path = tmp_path / "evil.pt"
    if isinstance(evil, str):
        _write_crafted(path, _CRAFTED[evil], legacy)
    else:
        torch.save({"w": torch.ones(2), "x": evil}, path, _use_new_zipfile_serialization=not legacy)

    for load in (tptread.load_pt, jptread.load_pt):
        with pytest.raises(pickle.UnpicklingError, match="not allowed"):
            load(str(path))


def test_a_global_is_refused_before_anything_runs(tmp_path, monkeypatch):
    class Boom:
        def __reduce__(self):
            return (os.system, ("exit 0",))

    path = tmp_path / "boom.pt"
    torch.save({"x": Boom()}, path)

    calls = []
    monkeypatch.setattr(os, "system", lambda cmd: calls.append(cmd))
    with pytest.raises(pickle.UnpicklingError):
        tptread.load_pt(path)
    assert not calls


def test_plain_pickled_tensors(tmp_path):
    r"""Tensors pickled outside `torch.save` (the NVlabs checkpoints) embed
    their storages through `torch.storage._load_from_bytes`; both restricted
    unpicklers read them."""

    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    obj = {"x": x[:, 1:], "h": torch.randn(4).half(), "p": torch.nn.Parameter(torch.ones(2)), "n": 3}
    data = pickle.dumps(obj)

    ours = tptread.RestrictedUnpickler(io.BytesIO(data)).load()
    theirs = jptread.RestrictedUnpickler(io.BytesIO(data)).load()
    for key in ("x", "h", "p"):
        assert torch.equal(ours[key], obj[key]) and np.array_equal(ours[key].detach().numpy(), theirs[key])
    assert ours["n"] == theirs["n"] == 3

    with pytest.raises(pickle.UnpicklingError, match="not allowed"):
        tptread.RestrictedUnpickler(io.BytesIO(pickle.dumps({"f": os.system}))).load()


def test_storage_bytes_go_back_through_the_restricted_load(monkeypatch):
    r"""The bytes that `_load_from_bytes` receives are read by `load_pt`: a
    refused global inside them is refused, and `torch.load` is never called
    without the restricted unpickler."""

    class Evil:
        def __reduce__(self):
            return (print, ("unpickled",))

    buffer = io.BytesIO()
    torch.save({"x": Evil()}, buffer, _use_new_zipfile_serialization=False)

    class Payload:
        def __reduce__(self):
            return (torch.storage._load_from_bytes, (buffer.getvalue(),))

    real_load = torch.load

    def guarded(*args, **kwargs):
        assert kwargs.get("pickle_module") is tptread._PICKLE
        return real_load(*args, **kwargs)

    monkeypatch.setattr(torch, "load", guarded)
    with pytest.raises(pickle.UnpicklingError, match=r"builtin\w*\.print"):
        tptread.RestrictedUnpickler(io.BytesIO(pickle.dumps(Payload()))).load()


# --------------------------------------------------------------- safetensors

_DTYPES = [torch.float64, torch.float32, torch.float16, torch.bfloat16, torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool]


def test_safetensors_reader_matches_the_package(tmp_path):
    st = pytest.importorskip("safetensors.torch")

    g = torch.Generator().manual_seed(0)
    sd = {}
    for i, dtype in enumerate(_DTYPES):
        # odd sizes put later tensors at offsets that are no multiple of 8
        shape = (3, 5) if i % 2 else (7,)
        if dtype.is_floating_point:
            value = torch.randn(shape, generator=g).to(dtype)
        elif dtype == torch.bool:
            value = torch.rand(shape, generator=g) < 0.5
        else:
            info = torch.iinfo(dtype)
            value = torch.randint(max(info.min, -(2**40)), min(info.max, 2**40), shape, generator=g, dtype=dtype)
        sd[f"t{i}.{str(dtype).removeprefix('torch.')}"] = value
    sd["scalar"] = torch.tensor(2.5)
    sd["empty"] = torch.zeros(0, 4)

    path = tmp_path / "all.safetensors"
    st.save_file(sd, str(path), metadata={"format": "pt"})

    ours, theirs = tutils.load_safetensors(path), st.load_file(str(path))
    assert list(ours) == list(theirs)
    for key, want in theirs.items():
        got = ours[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        assert torch.equal(got.reshape(-1).view(torch.uint8), want.reshape(-1).view(torch.uint8)), key
        assert torch.equal(got, sd[key]), key


def test_safetensors_reader_is_mapped_and_private(tmp_path):
    st = pytest.importorskip("safetensors.torch")

    path = tmp_path / "w.safetensors"
    st.save_file({"w": torch.arange(1024, dtype=torch.float32)}, str(path))
    before = path.read_bytes()

    w = tutils.load_safetensors(path)["w"]
    w.add_(1)  # a private mapping: the file is left as it was
    assert path.read_bytes() == before
    assert torch.equal(tutils.load_safetensors(path)["w"], torch.arange(1024, dtype=torch.float32))


def test_load_hub_safetensors_sharded(hubs, monkeypatch):
    r"""A sharded checkpoint (the single file answers 404, the index names
    two shards next to it) through both packages' `load_hub_safetensors`."""

    st = pytest.importorskip("safetensors.torch")

    repo, name = "org/model", "transformer/diffusion_pytorch_model"
    base = f"https://huggingface.co/{repo}/resolve/main"
    sd = {f"layer.{i}.weight": torch.randn(3, 2, generator=torch.Generator().manual_seed(i)) for i in range(4)}
    shards = {"model-00001-of-00002.safetensors": ["layer.0.weight", "layer.2.weight"], "model-00002-of-00002.safetensors": ["layer.1.weight", "layer.3.weight"]}

    for pkg, namer in ((thub, thub.cache_name), (jhub, jhub._safe_filename)):
        hub = pkg.get_hub_dir()
        hub.mkdir(parents=True)
        for shard, keys in shards.items():
            st.save_file({k: sd[k] for k in keys}, str(hub / namer(f"{base}/transformer/{shard}")))
        index = {"weight_map": {k: s for s, keys in shards.items() for k in keys}}
        (hub / namer(f"{base}/{name}.safetensors.index.json")).write_text(json.dumps(index))

    asked = []

    def not_found(url):
        asked.append(url)
        raise urllib.error.HTTPError(url, 404, "Not Found", None, None)

    monkeypatch.setattr(urllib.request, "urlopen", not_found)

    ours = tutils.load_hub_safetensors(repo, name)
    theirs = jutils.load_hub_safetensors(repo, name)
    assert asked == [f"{base}/{name}.safetensors"] * 2
    assert set(ours) == set(theirs) == set(sd)
    for key, value in sd.items():
        assert torch.equal(ours[key], value) and np.array_equal(np.asarray(theirs[key]), value.numpy())

    # an error other than 404 is raised as it is
    monkeypatch.setattr(urllib.request, "urlopen", lambda url: (_ for _ in ()).throw(urllib.error.HTTPError(url, 500, "", None, None)))
    with pytest.raises(urllib.error.HTTPError):
        tutils.load_hub_safetensors(repo, "other")
