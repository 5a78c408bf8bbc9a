r"""The PyTorch port's classifier-free guidance (`azula_tpu_torch.guidance.CFGDenoiser`)
on a tiny class-conditional ADM against the JAX package's, on the CPU, and
ADM's six cards (`azula_tpu_torch/models/adm/cards.yaml`) against the JAX
package's cards and its checkpoint manifests.

CFG's mean :math:`(1 + \omega) \mu_+ - \omega \mu_-` carries each mean's
difference (1e-4 of max |reference|, times :math:`\sigma_t / \alpha_t`
before the clip, as `test_torch_adm.py::test_denoiser_matches_jax` bounds
it) times :math:`1 + 2 \omega`. The batched form runs one call at batch
:math:`2B`; ADM's rows are independent, so on the CPU it equals the
two-call form to float32 rounding of the batch's own sums (1e-6).

Each card's state dict is checked without downloading anything: a stand-in
checkpoint with the manifest's keys and shapes goes through the JAX
package's converter (`azula_tpu/models/adm/convert.py`) and then through the
port's (`from_jax_state_dict`), which must fill every parameter of the
port's backbone, built on the meta device, with its shape.
"""

import json
import jax.numpy as jnp
import math
import numpy as np
import pathlib
import pytest
import torch
import torch_cpu  # noqa: F401  one thread a process

from azula_tpu.guidance import CFGDenoiser as JaxCFG
from azula_tpu.models import adm as jadm
from azula_tpu.models.adm.convert import convert_state_dict
from azula_tpu.models.utils import load_cards as jax_load_cards
from azula_tpu.sample import DDIMSampler as JaxDDIM
from azula_tpu.utils.pytree import filter_eval_shape, filter_jit
from azula_tpu_torch.guidance import CFGDenoiser
from azula_tpu_torch.models import adm as tadm
from azula_tpu_torch.models.adm.convert import from_jax_state_dict
from azula_tpu_torch.models.utils import load_cards
from azula_tpu_torch.sample import DDIMSampler as TorchDDIM

from test_torch_adm import CARD, _pair, _rel_err

TOL = 1e-4
GUIDANCE = 1.5
MANIFESTS = pathlib.Path(jadm.__file__).resolve().parents[1] / "manifests" / "adm"


@pytest.fixture(scope="module")
def cond_pair():
    return _pair(seed=70, num_classes=10, **CARD)


def _x(seed: int, batch: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((batch, 32, 32, 3)).astype(np.float32)


_jax_cfg = filter_jit(lambda d, x, t, pos, neg, w: d(x, t, positive={"label": pos}, negative={"label": neg}, guidance=w).mean)


def _bound(jd, t: float) -> float:
    alpha, sigma = jd.schedule(t)
    return TOL * max(1.0, float(sigma / alpha)) * (1 + 2 * GUIDANCE)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("negative", ["batch", "one", "scalar"])
def test_cfg_matches_jax(batched, negative, cond_pair):
    jd, td = cond_pair
    x = _x(71)
    pos = np.array([3, 7])
    neg = {"batch": np.array([0, 0]), "one": np.array([0]), "scalar": np.array(0)}[negative]

    jcfg, tcfg = JaxCFG(jd, batched=batched), CFGDenoiser(td, batched=batched)
    assert tcfg.schedule is td.schedule

    for t in (0.3, 0.9):
        if negative == "scalar" and not batched:
            continue  # an unbatched label is the fused form's reading only
        want = _jax_cfg(jcfg, jnp.asarray(x), jnp.float32(t), jnp.asarray(pos), jnp.asarray(neg), GUIDANCE)
        with torch.no_grad():
            got = tcfg(
                torch.from_numpy(x), torch.tensor(t), positive={"label": torch.from_numpy(pos)},
                negative={"label": torch.from_numpy(neg)}, guidance=GUIDANCE,
            ).mean

        assert got.shape == x.shape and got.dtype == torch.float32
        assert _rel_err(got, want) <= _bound(jd, t)


@pytest.mark.parametrize("time", ["scalar", "batch"])
def test_batched_equals_two_calls(time, cond_pair):
    _, td = cond_pair
    x = torch.from_numpy(_x(72))
    t = torch.tensor(0.6) if time == "scalar" else torch.tensor([0.6, 0.35])
    cond = dict(positive={"label": torch.tensor([1, 9])}, negative={"label": torch.tensor([0])}, guidance=GUIDANCE)  # noqa: C408

    with torch.no_grad():
        two = CFGDenoiser(td)(x, t, **{**cond, "negative": {"label": torch.tensor([0, 0])}}).mean
        one = CFGDenoiser(td, batched=True)(x, t, **cond).mean

    assert _rel_err(one, two.numpy()) <= 1e-6


@pytest.mark.parametrize("batched", [False, True])
def test_cfg_ddim_trajectory_matches_jax(batched, cond_pair):
    jd, td = cond_pair
    x = _x(73)
    pos, neg = np.array([2, 5]), np.array([0, 0])

    want = JaxDDIM(JaxCFG(jd, batched=batched), steps=4)(
        jnp.asarray(x), positive={"label": jnp.asarray(pos)}, negative={"label": jnp.asarray(neg)}, guidance=GUIDANCE
    )
    with torch.no_grad():
        got = TorchDDIM(CFGDenoiser(td, batched=batched), steps=4)(
            torch.from_numpy(x), positive={"label": torch.from_numpy(pos)},
            negative={"label": torch.from_numpy(neg)}, guidance=GUIDANCE,
        )

    # as test_torch_adm.py::test_ddim_trajectory_matches_jax, times 1 + 2 w
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, want) <= 5 * TOL * (1 + 2 * GUIDANCE)


def test_batched_contract_raises(cond_pair):
    _, td = cond_pair
    cfg = CFGDenoiser(td, batched=True)
    x, t = torch.from_numpy(_x(74)), torch.tensor(0.5)
    pos = {"label": torch.tensor([1, 2])}

    with pytest.raises(ValueError, match="share keys"):
        cfg(x, t, positive=pos, negative={}, guidance=GUIDANCE)
    with pytest.raises(ValueError, match="incompatible shapes"):
        cfg(x, t, positive=pos, negative={"label": torch.zeros((2, 2), dtype=torch.int64)}, guidance=GUIDANCE)
    with pytest.raises(ValueError, match="structures differ"):
        cfg(x, t, positive={"label": (torch.tensor([1, 2]),)}, negative={"label": torch.tensor([0, 0])})


def test_cfg_with_equal_conditioning_is_the_denoiser(cond_pair):
    _, td = cond_pair
    x, t = torch.from_numpy(_x(75)), torch.tensor(0.4)
    label = {"label": torch.tensor([4, 4])}

    with torch.no_grad():
        inner = td(x, t, **label).mean
        for batched in (False, True):
            got = CFGDenoiser(td, batched=batched)(x, t, positive=label, negative=label, guidance=2.5).mean
            assert _rel_err(got, inner.numpy()) <= 1e-6


# cards


def test_cards_equal_jax():
    ours = load_cards(tadm)
    theirs = jax_load_cards("azula_tpu.models.adm")

    assert list(ours) == list(theirs) and len(ours) == 6
    for name in ours:
        assert dict(ours[name].config) == dict(theirs[name].config), name
        assert ours[name].url == theirs[name].url


def _manifest(name: str) -> dict[str, tuple]:
    return {k: tuple(v) for k, v in json.loads((MANIFESTS / f"{name}.model.json").read_text()).items()}


@pytest.mark.parametrize("name", list(load_cards(tadm)))
def test_card_state_dict_matches_manifest(name):
    config = load_cards(tadm)[name].config
    manifest = _manifest(name)

    jbackbone = filter_eval_shape(jadm.make_model, **config).backbone
    assert convert_state_dict(jbackbone, None) == manifest  # the JAX converter's record of the card

    # zero-stride stand-ins: the converters read shapes and copy, nothing more
    checkpoint = {k: np.broadcast_to(np.int8(0), shape) for k, shape in manifest.items()}
    sd = convert_state_dict(jbackbone, checkpoint)

    port = tadm.make_model(**config, device="meta", generator=torch.Generator()).backbone
    converted = from_jax_state_dict(sd, port)  # raises on a missing, extra or misshapen key

    assert len(converted) == len(port.state_dict())
    n_params = sum(p.numel() for p in port.parameters())
    assert n_params == sum(math.prod(shape) for shape in manifest.values())
