r"""Checkpoint loading in the PyTorch port (`load_model` of the eight model
families, `skip_init`, the checkpoint readers, the digests) against the JAX
package's, on the CPU.

No checkpoint ships with the repository and no test reaches the network:
each test writes a checkpoint in the published layout (a guided-diffusion
`.pt`, a JiT archive, an NVlabs pickle, diffusers safetensors) from a small
randomly initialized module (the port's, or the torch twin that
`tests/test_load_offline.py` uses), seeds a hub directory with it under the
card's URL, and loads it through both packages' `load_model` with the same
cards, manifests (generated for the small architectures) and files;
`urllib.request.urlopen` raises throughout. The port's parameters must
equal the file's tensors and JAX's loaded parameters (through the port's
`from_jax_state_dict`) bit for bit, and the denoisers' outputs agree within
1e-5 of max |JAX| in float32, 2e-5 where a softmax sums 64 keys or more (for
ADM's mean, times sigma / alpha, its c_out, as `tests/test_torch_adm.py`
holds it).
Where `tests/test_load_offline.py` builds a committed digest without
external files, the port's `activation_digest` of its loaded model is held
to `digests/<name>.json`.
"""

import functools
import hashlib
import jax
import jax.numpy as jnp
import json
import math
import numpy as np
import pathlib
import pytest
import shutil
import tarfile
import torch
import urllib.error
import urllib.request

from types import SimpleNamespace

import azula_tpu.hub as jhub
import azula_tpu.models.utils as jutils
import azula_tpu_torch.hub as thub
import azula_tpu_torch.models.utils as tutils

from azula_tpu.utils.pytree import filter_jit, state_dict
from azula_tpu_torch.nn.utils import get_module_device, skip_init

ROOT = pathlib.Path(__file__).resolve().parents[1]

TOL = 1e-5
TOL_SOFTMAX = 2e-5

jax_mean = filter_jit(lambda denoiser, x, t, kwargs: denoiser(x, t, **kwargs).mean)


def _rel_err(got: torch.Tensor, want) -> float:
    got = got.detach().double().numpy()
    want = np.asarray(want, dtype=np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture
def hubs(tmp_path, monkeypatch):
    r"""Empty hub directories for both packages and no network: a file is
    found only where :func:`seed` put it."""

    def offline(*args, **kwargs):
        raise AssertionError("a test reached the network")

    monkeypatch.setattr(urllib.request, "urlopen", offline)
    monkeypatch.setattr(thub, "_HUB_DIR", tmp_path / "hub")
    monkeypatch.setattr(jhub, "_HUB_DIR", tmp_path / "jax_hub")
    return tmp_path


def seed(url: str, src) -> None:
    r"""Puts `src` in both hubs where their `download(url)` looks: the
    port's whole-URL cache name and the JAX package's basename."""

    for path in (thub.get_hub_dir() / thub.cache_name(url), jhub.get_hub_dir() / jhub._safe_filename(url)):
        path.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(src, path)


def manifests(monkeypatch, tmp_path, family: str) -> None:
    r"""The port's manifests of the (patched, small) architectures, read by
    both packages' `check_manifest`."""

    root = tmp_path / "manifests"
    tutils.generate_manifests(family, str(root))
    monkeypatch.setattr(tutils, "_manifest_dir", lambda: str(root))
    monkeypatch.setattr(jutils, "_manifest_dir", lambda: str(root))


def cards(monkeypatch, tmod, jmod, name: str, card) -> None:
    fake = lambda plugin: {name: card}  # noqa: E731
    for mod in (tmod, jmod, tutils):
        monkeypatch.setattr(mod, "load_cards", fake)


def randomize(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    r"""Seeded values for every floating tensor: norm weights about 1,
    biases and other vectors at 0.2, matrices and kernels at 1 / sqrt(fan
    in) (the initial values zero some output layers)."""

    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            if not t.is_floating_point():
                continue
            z = rng.standard_normal(tuple(t.shape))
            if t.ndim >= 2:
                z = z / math.sqrt(math.prod(t.shape[1:]))
            elif name.endswith("weight"):
                z = 1 + 0.2 * z
            else:
                z = 0.2 * z
            t.copy_(torch.from_numpy(z))
    return module


def hold_parameters(module, ckpt, canonicalize=None, dtype=None) -> None:
    r"""Every tensor of the loaded module equals the file's (reshaped where
    the file keeps a trailing 1, cast to `dtype`), bit for bit, and lies on
    the CPU."""

    names = {k: k for k in module.state_dict()}
    if canonicalize is not None:
        names, ckpt = canonicalize(names), canonicalize(ckpt)
    assert {names[k] for k in ckpt} == set(module.state_dict())

    own = module.state_dict()
    for key, want in ckpt.items():
        got = own[names[key]]
        want = want.reshape(got.shape)
        if dtype is not None and want.is_floating_point():
            want = want.to(dtype)
        assert got.dtype == want.dtype and torch.equal(got, want), key
        assert got.device.type == "cpu"


def hold_against_jax(tmodule, jmodule, from_jax) -> None:
    r"""JAX's loaded parameters, carried to the port's layout, equal the
    port's bit for bit."""

    want = from_jax({k: np.array(v) for k, v in state_dict(jmodule).items()})
    got = tmodule.state_dict()
    for key, value in want.items():
        assert torch.equal(got[key], value), key


def hold_digest(name: str, fn, shape) -> None:
    r"""The port's activation digest of a loaded model against the committed
    `digests/<name>.json` (its `activations`)."""

    want = json.loads((ROOT / "digests" / f"{name}.json").read_text())
    got = {"activations": tutils.activation_digest(fn, {"x": shape})}
    diffs = tutils.compare_digests(got, {"activations": want["activations"]})
    assert not diffs, "\n".join(diffs[:12])


def normal(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# --------------------------------------------------------------- .pt families

ADM_TINY = dict(  # noqa: C408
    image_size=32,
    num_channels=32,
    num_res_blocks=1,
    channel_mult=[1, 2],
    attention_resolutions=[16],
    num_classes=10,
    num_head_channels=16,
    use_scale_shift_norm=True,
    resblock_updown=True,
)


def test_adm_load_model(hubs, monkeypatch):
    from azula_tpu.models import adm as jadm
    from azula_tpu_torch.models import adm as tadm
    from azula_tpu_torch.models.adm.convert import canonicalize_adm_keys, from_jax_state_dict

    source = tadm.make_model(**ADM_TINY, device="cpu")
    randomize(source.backbone, 0)

    # the guided-diffusion layout: its names, the attention's conv1d kernels
    ckpt = canonicalize_adm_keys(source.backbone.state_dict())
    ckpt = {k: v[..., None] if k.endswith(("qkv.weight", "proj_out.weight")) else v for k, v in ckpt.items()}
    path = hubs / "adm.pt"
    torch.save(ckpt, path)

    url = "https://openaipublic.blob.core.windows.net/diffusion/jul-2021/tiny_diffusion.pt"
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    seed(url, path)
    cards(monkeypatch, tadm, jadm, "tiny", SimpleNamespace(url=url, hash=f"sha256:{digest[:16]}", config=ADM_TINY))
    manifests(monkeypatch, hubs, "adm")

    denoiser = tadm.load_model("tiny", device="cpu")
    jdenoiser = jadm.load_model("tiny")

    hold_parameters(denoiser.backbone, ckpt, canonicalize_adm_keys)
    hold_against_jax(denoiser.backbone, jdenoiser.backbone, from_jax_state_dict)
    assert torch.equal(denoiser.sigmas, source.sigmas) and get_module_device(denoiser).type == "cpu"

    x = normal(1, (2, 32, 32, 3))
    t = np.asarray([0.3, 0.7], dtype=np.float32)
    label = np.asarray([1, 7])
    want = jax_mean(jdenoiser, jnp.asarray(x), jnp.asarray(t), {"label": jnp.asarray(label)})
    with torch.no_grad():
        got = denoiser(torch.from_numpy(x), torch.from_numpy(t), label=torch.from_numpy(label)).mean
    # the mean carries the network's error times c_out = sigma / alpha
    alpha, sigma = denoiser.schedule(torch.from_numpy(t))
    assert _rel_err(got, want) < TOL_SOFTMAX * max(1.0, float((sigma / alpha).max()))

    # bf16 at load: the file's values cast, the tables as they were
    denoiser16 = tadm.load_model("tiny", dtype=torch.bfloat16, device="cpu")
    hold_parameters(denoiser16.backbone, ckpt, canonicalize_adm_keys, dtype=torch.bfloat16)
    assert denoiser16.sigmas.dtype == torch.float64

    # a wrong file fails on its hash, an absent card on the card
    seed(url, hubs / "adm.pt")
    (thub.get_hub_dir() / thub.cache_name(url)).write_bytes(b"not the file")
    with pytest.raises(RuntimeError, match="hash mismatch"):
        tadm.load_model("tiny", device="cpu")
    with pytest.raises(KeyError):
        tadm.load_model("imagenet_256x256", device="cpu")


def test_load_model_needs_the_card_or_a_device(monkeypatch):
    from azula_tpu_torch.models import adm as tadm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tadm.load_model("imagenet_256x256")


@pytest.mark.parametrize("entry", ["sd.load_unet", "edm.convert.build_from_pickle", "eldm.convert.build_from_pickle"])
def test_loaders_need_the_card_or_a_device(entry, monkeypatch, tmp_path):
    r"""The public loaders under `load_model` default to the card too: with
    no CUDA device and no `device`, they raise before reading the file."""

    import importlib

    module, _, name = entry.rpartition(".")
    loader = getattr(importlib.import_module(f"azula_tpu_torch.models.{module}"), name)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loader(tmp_path / "absent")


def test_vdm_load_model(hubs, monkeypatch):
    from azula_tpu.models import vdm as jvdm
    from azula_tpu.models.vdm.backbone import VDMSpec as JaxSpec
    from azula_tpu_torch.models import vdm as tvdm
    from azula_tpu_torch.models.vdm.backbone import VDMSpec
    from azula_tpu_torch.models.vdm.convert import from_jax_state_dict

    spec = dict(cs=(8, 16), blocks=1, inner=2, attn=(1,), head_dim=8, final_act=False, t_input="log_snr", up="nearest", std=0.2)  # noqa: C408
    monkeypatch.setattr(tvdm, "SPECS", {"tiny": VDMSpec(**spec)})
    monkeypatch.setattr(jvdm, "SPECS", {"tiny": JaxSpec(**spec)})

    ckpt = randomize(tvdm.make_model("tiny", device="cpu").backbone, 2).state_dict()
    path = hubs / "vdm.pth"
    torch.save(ckpt, path)

    url = "https://the-eye.eu/public/AI/models/v-diffusion/tiny_128.pth"
    seed(url, path)
    cards(monkeypatch, tvdm, jvdm, "tiny", SimpleNamespace(url=url, hash=None, config={"model": "tiny"}))
    manifests(monkeypatch, hubs, "vdm")

    denoiser = tvdm.load_model("tiny", device="cpu")
    jdenoiser = jvdm.load_model("tiny")

    hold_parameters(denoiser.backbone, ckpt)
    hold_against_jax(denoiser.backbone, jdenoiser.backbone, from_jax_state_dict)

    x = normal(2, (2, 16, 16, 3))
    t = np.asarray([0.4, 0.6], dtype=np.float32)
    with torch.no_grad():
        got = denoiser(torch.from_numpy(x), torch.from_numpy(t)).mean
    assert _rel_err(got, jax_mean(jdenoiser, jnp.asarray(x), jnp.asarray(t), {})) < TOL_SOFTMAX



JIT_TINY = dict(  # noqa: C408
    input_size=64,
    patch_size=16,
    hidden_size=64,
    depth=3,
    num_heads=4,
    num_classes=10,
    bottleneck_dim=16,
    in_context_len=4,
    in_context_start=1,
)


def test_jit_load_model(hubs, monkeypatch):
    r"""A JiT archive (a tar of `checkpoint-last.pth` holding `model` and
    `model_ema1` under `net.`), EMA and trained weights."""

    from azula_tpu.models import jit as jjit
    from azula_tpu_torch.models import jit as tjit
    from azula_tpu_torch.models.jit.convert import from_jax_state_dict

    monkeypatch.setattr(tjit, "JIT_CONFIGS", {"tiny": JIT_TINY})
    monkeypatch.setattr(jjit, "JIT_CONFIGS", {"tiny": JIT_TINY})

    ema = randomize(tjit.make_model("tiny", device="cpu").backbone, 3).state_dict()
    trained = randomize(tjit.make_model("tiny", device="cpu").backbone, 4).state_dict()

    (hubs / "jit").mkdir()
    torch.save(
        {"model": {f"net.{k}": v for k, v in trained.items()}, "model_ema1": {f"net.{k}": v for k, v in ema.items()}},
        hubs / "jit" / "checkpoint-last.pth",
    )
    with tarfile.open(hubs / "jit.tar", "w") as tar:
        tar.add(hubs / "jit" / "checkpoint-last.pth", arcname="checkpoint-last.pth")

    url = "https://www.dropbox.com/scl/fo/abc/jit-tiny?rlkey=xyz&dl=1"
    seed(url, hubs / "jit.tar")
    cards(monkeypatch, tjit, jjit, "tiny", SimpleNamespace(url=url, hash=None, config={"model": "tiny"}))
    manifests(monkeypatch, hubs, "jit")

    denoiser = tjit.load_model("tiny", device="cpu")
    hold_parameters(denoiser.backbone, ema)
    hold_parameters(tjit.load_model("tiny", ema=False, device="cpu").backbone, trained)

    jdenoiser = jjit.load_model("tiny")
    hold_against_jax(denoiser.backbone, jdenoiser.backbone, from_jax_state_dict)

    x = normal(5, (2, 64, 64, 3))
    t = np.asarray([0.3, 0.8], dtype=np.float32)
    label = np.asarray([0, 3])
    with torch.no_grad():
        got = denoiser(torch.from_numpy(x), torch.from_numpy(t), label=torch.from_numpy(label)).mean
    want = jax_mean(jdenoiser, jnp.asarray(x), jnp.asarray(t), {"label": jnp.asarray(label)})
    assert _rel_err(got, want) < TOL


# ------------------------------------------------------------ NVlabs pickles


def test_edm_load_model(hubs, monkeypatch):
    r"""The NVlabs pickle of `tests/test_load_offline.py` (the DDPM++ twin),
    read without the NVlabs source tree, and its committed digest."""

    from test_models_edm import SONG_SMALL, SONG_VARIANTS
    from torch_twins import edm_unet as twin

    from azula_tpu.models import edm as jedm
    from azula_tpu_torch.models import edm as tedm
    from azula_tpu_torch.models.edm.convert import from_jax_state_dict, load_nvlabs_pickle, stub_state_dict

    torch.manual_seed(0)
    cfg = {**SONG_SMALL, **SONG_VARIANTS["ddpmpp"]}
    source = twin.EDMPrecond(twin.SongUNet(**cfg)).eval()

    path = hubs / "edm.pkl"
    args = (cfg["img_resolution"], cfg["in_channels"], cfg["out_channels"])
    kwargs = {k: v for k, v in cfg.items() if k not in ("img_resolution", "in_channels", "out_channels")}
    twin.fake_nvlabs_pickle(path, source, args, kwargs)

    url = tedm.load_cards(tedm)["cifar10_32x32"].url
    seed(url, path)

    denoiser = tedm.load_model("cifar10_32x32", device="cpu")
    jdenoiser = jedm.load_model("cifar10_32x32")

    stub = stub_state_dict(load_nvlabs_pickle(path)["ema"])
    assert set(stub) == set(source.state_dict())
    hold_parameters(denoiser.backbone, source.state_dict())
    hold_against_jax(denoiser.backbone, jdenoiser.backbone, from_jax_state_dict)

    x = normal(6, (2, 16, 16, 3))
    t = np.asarray([0.5, 0.2], dtype=np.float32)
    with torch.no_grad():
        got = denoiser(torch.from_numpy(x), torch.from_numpy(t)).mean
    assert _rel_err(got, jax_mean(jdenoiser, jnp.asarray(x), jnp.asarray(t), {})) < TOL_SOFTMAX

    with torch.no_grad():
        hold_digest("edm_cifar10", lambda x, t: denoiser(x, t).mean, (2, 16, 16, 3))


def test_eldm_load_model(hubs, monkeypatch):
    r"""The EDM2 pickle with its encoder's statistics and the VAE's
    safetensors of `tests/test_load_offline.py`, and its committed digest."""

    from safetensors.torch import save_file
    from test_models_eldm import SMALL as EDM2_SMALL
    from torch_twins import edm2_unet as twin2
    from torch_twins.edm_unet import fake_edm2_pickle
    from torch_twins.vae import AutoencoderKLTwin

    import azula_tpu.models.autoencoder as jae
    import azula_tpu_torch.models.autoencoder as tae

    from azula_tpu.models import eldm as jeldm
    from azula_tpu_torch.models import eldm as teldm
    from azula_tpu_torch.models.eldm.convert import from_jax_state_dict

    torch.manual_seed(0)
    source = twin2.Precond(twin2.UNet(**EDM2_SMALL), label_dim=EDM2_SMALL["label_dim"]).eval()

    pkl = hubs / "edm2.pkl"
    names = ("img_resolution", "img_channels", "label_dim")
    args = tuple(EDM2_SMALL[k] for k in names)
    kwargs = {k: v for k, v in EDM2_SMALL.items() if k not in names}
    fake_edm2_pickle(pkl, source, args, kwargs, shift=0.25, scale=2.0)

    vae_cfg = dict(in_channels=3, latent_channels=4, block_out_channels=(32, 64), layers_per_block=1)  # noqa: C408
    vae = AutoencoderKLTwin(**vae_cfg).state_dict()
    save_file({k: v.contiguous() for k, v in vae.items()}, hubs / "vae.safetensors")

    seed(teldm.load_cards(teldm)["imagenet_512x512_xs"].url, pkl)
    seed(teldm.VAE_URL, hubs / "vae.safetensors")
    monkeypatch.setattr(tae, "AutoencoderKL", functools.partial(tae.AutoencoderKL, **vae_cfg))
    monkeypatch.setattr(jae, "AutoencoderKL", functools.partial(jae.AutoencoderKL, **vae_cfg))

    denoiser, autoencoder = teldm.load_model("imagenet_512x512_xs", device="cpu")
    jdenoiser, _ = jeldm.load_model("imagenet_512x512_xs")

    hold_parameters(denoiser.backbone, {k: v for k, v in source.state_dict().items() if not k.startswith("logvar")})
    hold_parameters(autoencoder.vae, vae, tae.canonicalize_vae_keys)
    hold_against_jax(denoiser.backbone, jdenoiser.backbone, from_jax_state_dict)
    assert torch.equal(autoencoder.shift, torch.full((4,), 0.25)) and torch.equal(autoencoder.scale, torch.full((4,), 2.0))

    label = torch.nn.functional.one_hot(torch.tensor([1, 2]), 10).float()
    x = normal(7, (2, 16, 16, 4))
    t = np.asarray([0.5, 0.3], dtype=np.float32)
    with torch.no_grad():
        got = denoiser(torch.from_numpy(x), torch.from_numpy(t), label=label).mean
    want = jax_mean(jdenoiser, jnp.asarray(x), jnp.asarray(t), {"label": jnp.asarray(label.numpy())})
    assert _rel_err(got, want) < TOL_SOFTMAX

    with torch.no_grad():
        hold_digest("eldm_imagenet_512_xs", lambda x, t: denoiser(x, t, label=label).mean, (2, 16, 16, 4))


# ---------------------------------------------------------- safetensors families


def tokenizer_files(root: pathlib.Path) -> pathlib.Path:
    r"""Local vocabulary files: a CLIP BPE vocabulary and merges, and a
    word-level `tokenizer.json` with T5's and Gemma's special tokens."""

    from tokenizers import Tokenizer, models, pre_tokenizers

    root.mkdir(exist_ok=True)
    letters = "abcdefghijklmnopqrstuvwxyz"
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1, **{c: i + 2 for i, c in enumerate(letters)}}
    vocab.update({f"{c}</w>": i + 28 for i, c in enumerate(letters)})
    (root / "vocab.json").write_text(json.dumps(vocab))
    (root / "merges.txt").write_text("#version: 0.2\n")

    words = ["<pad>", "</s>", "<unk>", "<bos>", "<eos>", "a", "red", "cat", "on", "the", "mat"]
    tokenizer = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token="<unk>"))
    tokenizer.pre_tokenizer = pre_tokenizers.Whitespace()
    tokenizer.save(str(root / "tokenizer.json"))
    return root


def write_safetensors(path: pathlib.Path, sd: dict) -> dict[str, torch.Tensor]:
    r"""Writes numpy arrays as the `safetensors` package does; returns the
    file's tensors as that package reads them."""

    from safetensors.numpy import save_file
    from safetensors.torch import load_file

    save_file(sd, str(path))
    return load_file(str(path))


def jax_normal(seed: int, shape) -> np.ndarray:
    return np.array(jax.random.normal(jax.random.key(seed), shape))


@pytest.mark.parametrize("card", ["sd_1.5", "sd_2"])
def test_sd_load_model(card, hubs, monkeypatch):
    r"""The UNet, VAE and CLIP files of `tests/test_load_offline.py` (the
    diffusers twins, `transformers`' CLIP), the tokenizer from local
    vocabulary files, and the committed digests."""

    from test_load_offline import CLIP_TINY, _np_sd, _tiny_clip_sd
    from torch_twins.sd_unet import UNet2DConditionTwin
    from torch_twins.vae import AutoencoderKLTwin

    import azula_tpu.models.autoencoder as jae
    import azula_tpu.models.sd.backbone as jsd_backbone
    import azula_tpu_torch.models.autoencoder as tae
    import azula_tpu_torch.models.clip as tclip
    import azula_tpu_torch.models.sd.backbone as tsd_backbone

    from azula_tpu.models import sd as jsd
    from azula_tpu_torch.models import sd as tsd
    from azula_tpu_torch.models.sd.convert import from_jax_state_dict

    torch.manual_seed(0)
    linear = card == "sd_2"
    unet_cfg = dict(  # noqa: C408
        in_channels=4,
        out_channels=4,
        block_out_channels=(32, 64),
        layers_per_block=1,
        cross_attention_dim=24,
        attention_head_dim=2,
        cross_attention_levels=(True, False),
        use_linear_projection=linear,
    )
    vae_cfg = dict(in_channels=3, latent_channels=4, block_out_channels=(32, 64), layers_per_block=1)  # noqa: C408
    arrays = {
        "unet": _np_sd(UNet2DConditionTwin(**unet_cfg)),
        "vae": _np_sd(AutoencoderKLTwin(**vae_cfg)),
        "text_encoder": _tiny_clip_sd(),
    }

    entry = tsd.load_cards(tsd)[card]
    base = f"https://huggingface.co/{entry.repo}/resolve/main"
    files, ckpt = {}, {}
    for component, name in (("unet", "diffusion_pytorch_model"), ("vae", "diffusion_pytorch_model"), ("text_encoder", "model")):
        sub = f"{component}/{name}.{entry.variant}.safetensors"
        files[sub] = hubs / f"{component}.safetensors"
        ckpt[component] = write_safetensors(files[sub], arrays[component])
    for sub in ("vocab.json", "merges.txt"):
        files[f"tokenizer/{sub}"] = tokenizer_files(hubs / "tokenizer") / sub

    for sub, path in files.items():
        thub_path = thub.get_hub_dir() / thub.cache_name(f"{base}/{sub}")
        thub_path.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(path, thub_path)
    # the JAX package's cache gives the unet and vae files one name
    monkeypatch.setattr(jsd, "_hub_file", lambda repo, sub: str(files[sub]))

    tiny = dict(  # noqa: C408
        unet=dict(cross_attention_dim=24, attention_head_dim=2, use_linear_projection=linear),  # noqa: C408
        clip=CLIP_TINY,
        scale=0.18215,
    )
    levels = dict(in_channels=4, out_channels=4, block_out_channels=(32, 64), layers_per_block=1, cross_attention_levels=(True, False))  # noqa: C408
    for mod, backbone, ae in ((tsd, tsd_backbone, tae), (jsd, jsd_backbone, jae)):
        monkeypatch.setattr(mod, "ARCHS", {"sd1": tiny, "sd2": tiny})
        monkeypatch.setattr(backbone, "SDUNet", functools.partial(backbone.SDUNet, **levels))
        monkeypatch.setattr(ae, "AutoencoderKL", functools.partial(ae.AutoencoderKL, **vae_cfg))
    manifests(monkeypatch, hubs, "sd")

    denoiser, autoencoder, textencoder = tsd.load_model(card, dtype=torch.float32, device="cpu")
    jdenoiser, _, _ = jsd.load_model(card, dtype=jnp.float32)

    assert denoiser.prediction == ("velocity" if linear else "epsilon")
    hold_parameters(denoiser.backbone, ckpt["unet"])
    hold_parameters(autoencoder.vae, ckpt["vae"], tae.canonicalize_vae_keys)
    hold_parameters(textencoder.clip, ckpt["text_encoder"], tclip.canonicalize_clip_keys)
    hold_against_jax(denoiser.backbone, jdenoiser.backbone, from_jax_state_dict)

    ctx = jax_normal(1, (1, 7, 24))
    z = normal(8, (2, 16, 16, 4))
    t = np.asarray([0.4, 0.7], dtype=np.float32)
    with torch.no_grad():
        got = denoiser(torch.from_numpy(z), torch.from_numpy(t), prompt_embeds=torch.from_numpy(ctx)).mean
    want = jax_mean(jdenoiser, jnp.asarray(z), jnp.asarray(t), {"prompt_embeds": jnp.asarray(ctx)})
    assert _rel_err(got, want) < TOL_SOFTMAX

    with torch.no_grad():
        fn = lambda x, t: denoiser(x, t, prompt_embeds=torch.from_numpy(ctx)).mean  # noqa: E731
        hold_digest(f"sd_{card}".replace(".", "_"), fn, (2, 16, 16, 4))

        # the prompt through the tokenizer built from the vocabulary files
        assert textencoder.tokenizer.model_max_length == CLIP_TINY["max_positions"]
        embeds = textencoder("a red cat")["prompt_embeds"]
    assert embeds.shape == (1, CLIP_TINY["max_positions"], CLIP_TINY["hidden"]) and torch.isfinite(embeds).all()


def test_flux_load_model(hubs, monkeypatch):
    r"""The transformer, VAE, CLIP and T5 files of `tests/test_load_offline.py`,
    the transformer sharded, both tokenizers from local files, the committed
    digest, and a drifted checkpoint refused by name."""

    from test_load_offline import CLIP_TINY, _np_sd, _tiny_clip_sd
    from torch_twins.flux_mmdit import FluxTransformerTwin
    from torch_twins.vae import AutoencoderKLTwin
    from transformers import T5Config, T5EncoderModel

    import azula_tpu.models.autoencoder as jae
    import azula_tpu.models.clip as jclip
    import azula_tpu.models.flux.backbone as jflux_backbone
    import azula_tpu.models.t5 as jt5
    import azula_tpu_torch.models.autoencoder as tae
    import azula_tpu_torch.models.clip as tclip
    import azula_tpu_torch.models.flux.backbone as tflux_backbone
    import azula_tpu_torch.models.t5 as tt5

    from azula_tpu.models import flux as jflux
    from azula_tpu_torch.models import flux as tflux
    from azula_tpu_torch.models.flux.convert import from_jax_state_dict

    torch.manual_seed(0)
    flux_cfg = dict(  # noqa: C408
        in_channels=16,
        num_layers=2,
        num_single_layers=2,
        attention_head_dim=24,
        num_attention_heads=2,
        joint_attention_dim=32,
        pooled_projection_dim=24,
        axes_dims_rope=(8, 8, 8),
    )
    t5_cfg = dict(vocab_size=99, dim=32, heads=4, head_dim=8, ff_dim=64, layers=2)  # noqa: C408
    t5 = T5EncoderModel(
        T5Config(
            vocab_size=99, d_model=32, num_heads=4, d_kv=8, d_ff=64, num_layers=2, feed_forward_proj="gated-gelu"
        )
    )
    arrays = {
        "transformer/diffusion_pytorch_model": _np_sd(FluxTransformerTwin(**flux_cfg, guidance_embeds=True)),
        "vae/diffusion_pytorch_model": _np_sd(
            AutoencoderKLTwin(in_channels=3, latent_channels=16, block_out_channels=(32, 64), layers_per_block=1, use_quant_conv=False)
        ),
        "text_encoder/model": _tiny_clip_sd(),
        "text_encoder_2/model": _np_sd(t5),
    }

    base = f"https://huggingface.co/{tflux.load_cards(tflux)['flux_1_dev'].repo}/resolve/main"
    ckpt = {}
    for name, sd in arrays.items():
        if name.startswith("transformer/"):  # two shards and their index
            keys = sorted(sd)
            shards = {"a.safetensors": keys[::2], "b.safetensors": keys[1::2]}
            ckpt[name] = {}
            for shard, part in shards.items():
                ckpt[name].update(write_safetensors(hubs / shard, {k: sd[k] for k in part}))
                seed(f"{base}/transformer/diffusion_pytorch_model-{shard}", hubs / shard)
            index = {"weight_map": {k: f"diffusion_pytorch_model-{s}" for s, part in shards.items() for k in part}}
            (hubs / "index.json").write_text(json.dumps(index))
            seed(f"{base}/{name}.safetensors.index.json", hubs / "index.json")
        else:
            path = hubs / f"{name.replace('/', '_')}.safetensors"
            ckpt[name] = write_safetensors(path, sd)
            seed(f"{base}/{name}.safetensors", path)
    tok = tokenizer_files(hubs / "tokenizer")
    for sub, name in (("tokenizer/vocab.json", "vocab.json"), ("tokenizer/merges.txt", "merges.txt"), ("tokenizer_2/tokenizer.json", "tokenizer.json")):
        seed(f"{base}/{sub}", tok / name)

    def no_single_file(url, *args, **kwargs):
        # the sharded transformer answers 404 where the single file would be
        if url.endswith("transformer/diffusion_pytorch_model.safetensors"):
            raise urllib.error.HTTPError(url, 404, "Not Found", None, None)
        raise AssertionError("a test reached the network")

    monkeypatch.setattr(urllib.request, "urlopen", no_single_file)
    # the JAX package's cache gives both text encoders' files one name, and
    # its loader hands `transformers` the Path that `download` returns
    monkeypatch.setattr(jutils, "load_hub_safetensors", lambda repo, name, variant=None: arrays[name])
    monkeypatch.setattr(jhub, "download", functools.partial(lambda get, url, **kw: str(get(url, **kw)), jhub.download))

    for mod, backbone, ae, clip, t5_mod in ((tflux, tflux_backbone, tae, tclip, tt5), (jflux, jflux_backbone, jae, jclip, jt5)):
        monkeypatch.setattr(backbone, "FluxTransformer", functools.partial(backbone.FluxTransformer, **flux_cfg))
        monkeypatch.setattr(ae, "AutoencoderKL", functools.partial(ae.AutoencoderKL, in_channels=3, block_out_channels=(32, 64), layers_per_block=1))
        monkeypatch.setattr(clip, "CLIPTextEncoder", functools.partial(clip.CLIPTextEncoder, **CLIP_TINY))
        monkeypatch.setattr(t5_mod, "T5Encoder", functools.partial(t5_mod.T5Encoder, **t5_cfg))
    manifests(monkeypatch, hubs, "flux")

    denoiser, autoencoder, textencoder = tflux.load_model("flux_1_dev", dtype=torch.float32, device="cpu")
    jdenoiser, _, _ = jflux.load_model("flux_1_dev", dtype=jnp.float32)

    hold_parameters(denoiser.backbone, ckpt["transformer/diffusion_pytorch_model"])
    hold_parameters(autoencoder.vae, ckpt["vae/diffusion_pytorch_model"], tae.canonicalize_vae_keys)
    hold_parameters(textencoder.clip, ckpt["text_encoder/model"], tclip.canonicalize_clip_keys)
    hold_parameters(textencoder.t5, ckpt["text_encoder_2/model"], tt5.canonicalize_t5_keys)
    hold_against_jax(denoiser.backbone, jdenoiser.backbone, from_jax_state_dict)

    pooled, seq = jax_normal(1, (1, 24)), jax_normal(2, (1, 6, 32))
    prompt = {"prompt_clip": pooled, "prompt_t5": seq}
    z = normal(9, (2, 4, 4, 16))
    t = np.asarray([0.3, 0.6], dtype=np.float32)
    with torch.no_grad():
        got = denoiser(torch.from_numpy(z), torch.from_numpy(t), **{k: torch.from_numpy(v) for k, v in prompt.items()}).mean
    want = jax_mean(jdenoiser, jnp.asarray(z), jnp.asarray(t), {k: jnp.asarray(v) for k, v in prompt.items()})
    assert _rel_err(got, want) < TOL

    with torch.no_grad():
        fn = lambda x, t: denoiser(x, t, **{k: torch.from_numpy(v) for k, v in prompt.items()}).mean  # noqa: E731
        hold_digest("flux_1_dev", fn, (2, 4, 4, 16))
        out = textencoder("a red cat")
    assert out["prompt_clip"].shape == (1, 24) and out["prompt_t5"].shape == (1, 512, 32)

    # a drifted checkpoint is refused by name, before anything is loaded
    broken = dict(arrays["transformer/diffusion_pytorch_model"])
    broken["unexpected.weight"] = broken.pop(sorted(broken)[0])
    monkeypatch.setattr(tutils, "load_hub_safetensors", lambda repo, name, variant=None: {k: torch.from_numpy(v) for k, v in (broken if name.startswith("transformer/") else arrays[name]).items()})
    with pytest.raises(ValueError, match="manifest"):
        tflux.load_model("flux_1_dev", device="cpu")


@pytest.mark.parametrize("card", ["sana_0.6b_512", "sana_1.5_1.6b_1024"])
def test_sana_load_model(card, hubs, monkeypatch):
    r"""The transformer, Gemma and DC-AE files of `tests/test_load_offline.py`,
    the tokenizer from a local file, the card's dtypes, and the committed
    digests."""

    from torch_twins.dc_ae import AutoencoderDCTwin
    from torch_twins.sana_dit import SanaTransformerTwin
    from transformers import Gemma2Config, Gemma2Model

    from test_load_offline import _np_sd

    import azula_tpu.models.gemma as jgemma
    import azula_tpu.models.sana.autoencoder as jdcae
    import azula_tpu_torch.models.gemma as tgemma
    import azula_tpu_torch.models.sana.autoencoder as tdcae

    from azula_tpu.models import sana as jsana
    from azula_tpu_torch.models import sana as tsana
    from azula_tpu_torch.models.sana.convert import from_jax_state_dict

    torch.manual_seed(0)
    dit_cfg = dict(  # noqa: C408
        in_channels=8,
        out_channels=8,
        num_attention_heads=4,
        attention_head_dim=8,
        num_cross_attention_heads=2,
        cross_attention_head_dim=16,
        caption_channels=32,
        num_layers=2,
        patch_size=1,
        mlp_ratio=2.5,
        qk_norm="1.5" in card,
    )
    gemma_cfg = dict(  # noqa: C408
        vocab_size=127,
        dim=32,
        layers=2,
        heads=4,
        kv_heads=2,
        head_dim=8,
        intermediate=64,
        query_pre_attn_scalar=8.0,
        attn_logit_softcapping=50.0,
        sliding_window=5,
    )
    dcae_cfg = dict(  # noqa: C408
        in_channels=3,
        latent_channels=8,
        block_types=("ResBlock", "EfficientViTBlock"),
        block_out_channels=(8, 16),
        encoder_layers_per_block=(1, 1),
        decoder_layers_per_block=(1, 1),
        qkv_multiscales=((), (5,)),
        head_dim=4,
    )
    gemma = Gemma2Model(
        Gemma2Config(
            vocab_size=127,
            hidden_size=32,
            num_hidden_layers=2,
            num_attention_heads=4,
            num_key_value_heads=2,
            head_dim=8,
            intermediate_size=64,
            query_pre_attn_scalar=8.0,
            attn_logit_softcapping=50.0,
            sliding_window=5,
            attn_implementation="eager",
        )
    )
    entry = tsana.load_cards(tsana)[card]
    variant = f".{entry.variant}" if entry.variant else ""
    arrays = {
        "transformer/diffusion_pytorch_model": _np_sd(SanaTransformerTwin(**dit_cfg)),
        "text_encoder/model": _np_sd(gemma),
        "vae/diffusion_pytorch_model": _np_sd(AutoencoderDCTwin(**dcae_cfg)),
    }

    base = f"https://huggingface.co/{entry.repo}/resolve/main"
    ckpt = {}
    for name, sd in arrays.items():
        path = hubs / f"{name.replace('/', '_')}.safetensors"
        ckpt[name] = write_safetensors(path, sd)
        seed(f"{base}/{name}{variant if name.startswith('transformer/') else ''}.safetensors", path)
    seed(f"{base}/tokenizer/tokenizer.json", tokenizer_files(hubs / "tokenizer") / "tokenizer.json")

    monkeypatch.setattr(jutils, "load_hub_safetensors", lambda repo, name, variant=None: arrays[name])
    monkeypatch.setattr(jhub, "download", functools.partial(lambda get, url, **kw: str(get(url, **kw)), jhub.download))
    for mod, gm, dc in ((tsana, tgemma, tdcae), (jsana, jgemma, jdcae)):
        monkeypatch.setattr(mod, "ARCHS", {"0.6b": dit_cfg, "1.6b": dit_cfg, "1.5-1.6b": dit_cfg, "1.5-4.8b": dit_cfg})
        monkeypatch.setattr(gm, "Gemma2TextModel", functools.partial(gm.Gemma2TextModel, **gemma_cfg))
        monkeypatch.setattr(dc, "AutoencoderDC", functools.partial(dc.AutoencoderDC, **dcae_cfg))
    manifests(monkeypatch, hubs, "sana")

    denoiser, autoencoder, textencoder = tsana.load_model(card, dtype=torch.float32, device="cpu")
    jdenoiser, _, _ = jsana.load_model(card, dtype=jnp.float32)

    hold_parameters(denoiser.backbone, ckpt["transformer/diffusion_pytorch_model"])
    hold_parameters(textencoder.gemma, ckpt["text_encoder/model"], tgemma.canonicalize_gemma_keys, dtype=torch.bfloat16)
    hold_parameters(autoencoder.ae, ckpt["vae/diffusion_pytorch_model"])
    hold_against_jax(denoiser.backbone, jdenoiser.backbone, from_jax_state_dict)

    ctx, mask = jax_normal(1, (1, 6, 32)), np.ones((1, 6), dtype=np.float32)
    prompt = {"prompt_embeds": ctx, "prompt_mask": mask}
    z = normal(10, (2, 8, 8, 8))
    t = np.asarray([0.4, 0.9], dtype=np.float32)
    with torch.no_grad():
        got = denoiser(torch.from_numpy(z), torch.from_numpy(t), **{k: torch.from_numpy(v) for k, v in prompt.items()}).mean
    want = jax_mean(jdenoiser, jnp.asarray(z), jnp.asarray(t), {k: jnp.asarray(v) for k, v in prompt.items()})
    assert _rel_err(got, want) < TOL

    with torch.no_grad():
        fn = lambda x, t: denoiser(x, t, **{k: torch.from_numpy(v) for k, v in prompt.items()}).mean  # noqa: E731
        hold_digest(card, fn, (2, 8, 8, 8))
        out = textencoder("a red cat", instructions=())
    assert out["prompt_embeds"].shape == (1, 300, 32) and torch.isfinite(out["prompt_embeds"].float()).all()


# ------------------------------------------------------- skip_init, manifests


@pytest.mark.parametrize("family, card", [("adm", "imagenet_256x256"), ("vdm", "imagenet_128x128"), ("jit", "jit_0.1b_16")])
def test_skip_init_allocates_no_storage(family, card):
    r"""`make_model` builds on the meta device at full size: no parameter
    storage, no generator; the tables computed from the configuration are
    built on the CPU, and equal those of a real build."""

    import importlib

    plugin = importlib.import_module(f"azula_tpu_torch.models.{family}")
    config = tutils.load_cards(plugin)[card].config
    denoiser = skip_init(plugin.make_model, **config)

    assert all(p.is_meta for p in denoiser.parameters())
    assert all(b.device.type == "cpu" for b in denoiser.buffers())
    assert get_module_device(denoiser.backbone).type == "meta"
    tutils.check_manifest(denoiser.backbone.state_dict(), family, card, "model", getattr(plugin, "canonicalize_adm_keys", None))

    with pytest.raises(TypeError, match="meta"):
        skip_init(plugin.make_model, **config, device="cpu")


def test_skip_init_sd_unet_and_the_tables():
    from azula_tpu_torch.models import adm as tadm
    from azula_tpu_torch.models import jit as tjit
    from azula_tpu_torch.models import sd as tsd
    from azula_tpu_torch.nn.layers import Linear

    unet = skip_init(tsd.make_backbone, "sd_2")
    assert all(p.is_meta for p in unet.parameters())
    assert sum(p.numel() for p in unet.parameters()) == 865910724
    tutils.check_manifest(unet.state_dict(), "sd", "sd_2", "unet")

    layer = skip_init(Linear, 3, 5)
    assert layer.weight.is_meta and get_module_device(layer).type == "meta"
    assert get_module_device(torch.nn.ReLU()) is None

    # the tables are those of a real build, on the CPU
    small = dict(image_size=32, num_channels=32, num_res_blocks=1, channel_mult=[1, 2], attention_resolutions=[16])  # noqa: C408
    assert torch.equal(skip_init(tadm.make_model, **small).sigmas, tadm.make_model(**small, device="cpu").sigmas)
    tiny = skip_init(tjit.make_model, "JiT-B/16", depth=1)
    real = tjit.make_model("JiT-B/16", depth=1, device="cpu")
    for name in ("rope_cos", "rope_sin", "rope_incontext_cos", "rope_incontext_sin"):
        assert torch.equal(getattr(tiny.backbone, name), getattr(real.backbone, name)), name


def test_make_model_draws_are_unchanged_off_meta():
    r"""Building on a real device draws the parameters as before: the
    generator seeded with 0 by default."""

    from azula_tpu_torch.models import adm as tadm

    small = dict(image_size=32, num_channels=32, num_res_blocks=1, channel_mult=[1, 2], attention_resolutions=[16])  # noqa: C408
    a = tadm.make_model(**small, device="cpu")
    b = tadm.make_model(**small, device="cpu", generator=torch.Generator().manual_seed(0))
    for (name, x), y in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("family", ["adm", "vdm", "jit", "sd", "flux", "sana"])
def test_generate_manifests_matches_the_packaged(family, tmp_path):
    r"""The manifests taken from the port's modules on the meta device are
    the packaged ones (where those record a shape)."""

    written = tutils.generate_manifests(family, str(tmp_path))
    packaged = sorted((ROOT / "azula_tpu_torch" / "models" / "manifests" / family).glob("*.json"))
    assert sorted(pathlib.Path(p).name for p in written) == [p.name for p in packaged]

    for path in packaged:
        want = json.loads(path.read_text())
        got = json.loads((tmp_path / family / path.name).read_text())
        assert set(got) == set(want), path.name
        for key, shape in want.items():
            if shape is not None:
                assert got[key][: len(shape)] == shape and all(d == 1 for d in got[key][len(shape) :]), (path.name, key)


# ------------------------------------------------------------------- digests


def test_probes_are_jax_draws():
    r"""The digests' probes are `jax.random.normal`'s, bit for bit in the
    generator and within an ulp or two after the inverse error function."""

    k_x, k_p = jax.random.split(jax.random.key(0))
    a, b = tutils._threefry2x32((0, 0), np.zeros(2, np.uint32), np.arange(2, dtype=np.uint32))
    assert (int(a[0]), int(b[0])) == tuple(int(v) for v in jax.random.key_data(k_x))
    assert (int(a[1]), int(b[1])) == tuple(int(v) for v in jax.random.key_data(k_p))

    for key, shape in ((k_x, (2, 16, 16, 4)), (k_p, (8, 3 * 5 * 7))):
        data = tuple(int(v) for v in jax.random.key_data(key))
        got, want = tutils._jax_normal(data, shape), np.asarray(jax.random.normal(key, shape))
        assert got.dtype == np.float32 and np.abs(got - want).max() <= 4 * np.spacing(np.abs(want).max())


def test_digests_against_jax():
    r"""`weight_digest`, `activation_digest` and `compare_digests` give the
    JAX package's documents on the same state dict and function."""

    rng = np.random.default_rng(0)
    sd = {"b": rng.standard_normal((4, 3)).astype(np.float32), "a": rng.standard_normal(5).astype(np.float32)}
    assert tutils.weight_digest({k: torch.from_numpy(v) for k, v in sd.items()}) == jutils.weight_digest(sd)

    w = rng.standard_normal((3, 3)).astype(np.float32)
    got = tutils.activation_digest(lambda x, t: torch.tanh(x @ torch.from_numpy(w)) * t[:, None, None, None], {"x": (2, 4, 5, 3)})
    want = jutils.activation_digest(lambda x, t: jnp.tanh(x @ w) * t[:, None, None, None], {"x": (2, 4, 5, 3)})
    assert not tutils.compare_digests({"activations": got}, {"activations": want})

    off = [dict(r, mean=r["mean"] + 0.01) for r in want]
    assert tutils.compare_digests({"activations": got}, {"activations": off}) == jutils.compare_digests({"activations": got}, {"activations": off})
    assert tutils.compare_digests({"weights": {}}, {}) == ["weights: present in one digest only"]


def test_text_libraries_stay_inside_load_model():
    r"""The port imports `transformers` only inside the text families'
    `load_model` (for the tokenizers), and `safetensors` nowhere: the
    card's machine has neither."""

    import ast

    found = []

    def visit(node, function):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in child.names] if isinstance(child, ast.Import) else [child.module or ""]
                for name in names:
                    top = name.split(".")[0]
                    if top in ("transformers", "safetensors"):
                        found.append((path.relative_to(ROOT).as_posix(), function, top))
            visit(child, child.name if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)) else function)

    for path in sorted((ROOT / "azula_tpu_torch").rglob("*.py")):
        visit(ast.parse(path.read_text()), None)

    assert sorted(found) == [
        ("azula_tpu_torch/models/flux/__init__.py", "load_model", "transformers"),
        ("azula_tpu_torch/models/sana/__init__.py", "load_model", "transformers"),
        ("azula_tpu_torch/models/sd/__init__.py", "load_model", "transformers"),
    ]
