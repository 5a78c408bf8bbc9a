r"""Each plain reference against the port's model at tiny widths on the CPU,
both in float32 with the same state dict: the first network output and a
three-step DDIM sample."""

from __future__ import annotations

import pytest
import torch

from conftest import TINY_ADM, TINY_CELLS, TINY_FLUX
from harness import draw, runner

import configs_under_test as cut

# float32 on both sides: products summed in other orders, the port's float32
# timestep embedding against the reference's float64 one
TOL = 1e-4


@pytest.mark.parametrize("name,config,cell", [
    ("adm256", TINY_ADM, "tiny_adm.ddim3_b4"),
    ("flux1_dev", TINY_FLUX, "tiny_flux.ddim3_b2"),
])
def test_reference_matches_the_port(name, config, cell):
    config = {**config, "dtype": "float32"}
    traffic = TINY_CELLS[cell]
    conf, ref = cut.configuration(name), cut.reference(name)
    shapes = conf.parameters(config)
    x, cond = conf.inputs(config, traffic, 9, 0, "cpu")
    cond = {k: v.float() if isinstance(v, torch.Tensor) else v for k, v in cond.items()}

    denoiser = conf.build(config, draw.weights(shapes, 9, "cpu", torch.float32), torch.device("cpu"))
    first = []
    conf.network(denoiser).register_forward_hook(lambda m, a, out: first.append(out.clone()) and None)
    sampler = runner.sampler_class(traffic["sampler"])(denoiser, steps=traffic["steps"], eta=traffic["eta"])
    with torch.no_grad():
        final = sampler(x, **cond)

    want_first, want_final = ref.trajectory(config, traffic, draw.weights(shapes, 9, "cpu", torch.float32), x, cond)

    assert runner.gap(first[0], want_first) < TOL
    assert runner.gap(final, want_final) < TOL


def test_state_dict_is_the_ports(tmp_path):
    r"""The references' parameter names and shapes are the port's: the
    program loads the drawn state dict strictly."""

    for name, config in (("adm256", TINY_ADM), ("flux1_dev", TINY_FLUX)):
        conf = cut.configuration(name)
        state = draw.weights(conf.parameters(config), 1, "cpu", torch.bfloat16)
        denoiser = conf.build(config, state, torch.device("cpu"))
        assert set(dict(conf.network(denoiser).named_parameters())) == set(state)


def test_draws_repeat_and_differ_by_seed():
    shapes = {"a.weight": (3, 5), "a.bias": (3,), "n.weight": (7,), "n.bias": (7,)}
    one = draw.weights(shapes, 2**40 + 3, "cpu", torch.bfloat16)
    two = draw.weights(shapes, 2**40 + 3, "cpu", torch.bfloat16)
    three = draw.weights(shapes, 2**40 + 4, "cpu", torch.bfloat16)
    assert all(torch.equal(one[k], two[k]) for k in shapes)
    assert not torch.equal(one["a.weight"], three["a.weight"])
    assert one["a.weight"].abs().max() <= 1 / 5**0.5 and one["a.bias"].abs().max() <= 1 / 5**0.5
    assert (one["n.weight"] - 1).abs().max() <= 0.1 and one["n.bias"].abs().max() <= 0.1
