r"""The configurations' count functions against what the plain references
compute at small widths: FLOPs by `torch.utils.flop_counter.FlopCounterMode`,
the GroupNorm and attention calls by recording them."""

from __future__ import annotations

import pytest
import torch

from torch.utils.flop_counter import FlopCounterMode

from conftest import TINY_ADM, TINY_CELLS, TINY_FLUX
from harness import draw
from reference import common

import configs_under_test as cut


def _run_reference(name, config, traffic):
    module = cut.reference(name)
    state = draw.weights(module.parameters(config), 3, "cpu", torch.float32)
    configuration = cut.configuration(name)
    x, cond = configuration.inputs(config, traffic, 3, 0, "cpu")
    cond = {k: v.float() if isinstance(v, torch.Tensor) else v for k, v in cond.items()}
    one_step = {**traffic, "steps": 1}
    with FlopCounterMode(display=False) as counter:
        module.trajectory(config, one_step, state, x, cond)
    return counter.get_total_flops()


@pytest.mark.parametrize("name,config,cell", [
    ("adm256", TINY_ADM, "tiny_adm.ddim3_b4"),
    ("flux1_dev", TINY_FLUX, "tiny_flux.ddim3_b2"),
])
def test_flops_match_the_reference(name, config, cell):
    traffic = TINY_CELLS[cell]
    counted = cut.configuration(name).counts(config, traffic)["flops"]
    assert _run_reference(name, config, traffic) == counted


def test_groupnorm_and_attention_calls_match_the_adm_reference(monkeypatch):
    ref = cut.reference("adm256")
    traffic = TINY_CELLS["tiny_adm.ddim3_b4"]
    seen_gn, seen_attn = [], []
    norm_forward, attention = ref.Norm.forward, common.Ops.attention

    def norm(self, x):
        seen_gn.append(tuple(x.shape))
        return norm_forward(self, x)

    def attend(self, q, k, v):
        seen_attn.append((q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3]))
        return attention(self, q, k, v)

    monkeypatch.setattr(ref.Norm, "forward", norm)
    monkeypatch.setattr(common.Ops, "attention", attend)
    _run_reference("adm256", TINY_ADM, traffic)

    counts = cut.configuration("adm256").counts(TINY_ADM, traffic)
    item, B = counts["itemsize"], traffic["batch"]
    # every ResBlock's second norm is modulated by a per-row scale and shift
    blocks = [m for m in ref.UNet(TINY_ADM["model"]).modules() if isinstance(m, ref.ResBlock)]
    modulated = sum(item * 2 * B * m.out_norm.weight.shape[0] for m in blocks)
    nbytes = sum(item * (2 * b * c * h * w + 2 * c) for b, c, h, w in seen_gn)
    assert nbytes + modulated == counts["gn_bytes"]
    assert len(seen_gn) == 2 * len(blocks) + len(counts["attention"]) + 1
    assert sorted(seen_attn) == sorted(counts["attention"])


def test_full_width_counts():
    r"""The published sizes' work per network call: ADM-256 at batch 16
    about 35.5 TFLOP (2.2 a image); FLUX.1-dev at 1024 px about 59.4 TFLOP
    of linear layers and 14.9 of attention in 57 calls at L = 4608."""

    import json

    from conftest import BENCH

    adm = json.loads((BENCH / "configs" / "adm256.json").read_text())
    flux = json.loads((BENCH / "configs" / "flux1_dev.json").read_text())
    a = cut.configuration("adm256").counts(adm, {"batch": 16})
    f = cut.configuration("flux1_dev").counts(flux, {"batch": 1, "latent_side": 64, "text_tokens": 512})
    assert 2.1e12 < a["flops"] / 16 < 2.3e12
    assert len(a["attention"]) == 16
    attention = sum(4 * b * h * lq * lk * d for b, h, lq, lk, d in f["attention"])
    assert len(f["attention"]) == 57 and f["attention"][0] == (1, 24, 4608, 4608, 128)
    assert 14.8e12 < attention < 15.0e12 and 59.0e12 < f["flops"] - attention < 59.8e12
