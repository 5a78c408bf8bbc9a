r"""The port's spans and kernel records (`azula_tpu_torch.utils.profiling`):
a tiny ADM and a tiny Flux sampled under `torch.profiler` on the CPU show
the spans nested step > denoiser call > block > kernel op, in exact counts;
each kernel op's record holds the work of its call's shapes, counted here
by hand (the ops whose work no metric reads keep none); with no profiler recording, no region is opened and nothing is
kept; a compiled denoiser gives what the eager one gives, traced or not,
and opens no span in the code that `torch.compile` traces.
"""

import collections
import pytest
import torch
import torch_cpu  # noqa: F401  one thread a process

from azula_tpu_torch.models import adm
from azula_tpu_torch.models.flux import FluxDenoiser
from azula_tpu_torch.models.flux.backbone import FluxTransformer
from azula_tpu_torch.ops import conv3x3, dot_product_attention, fused_msa_attention
from azula_tpu_torch.ops import group_norm, group_norm_silu, group_stats, residual_add
from azula_tpu_torch.sample import DDIMSampler, zEABSampler
from azula_tpu_torch.utils import profiling

STEPS = 3

TINY_ADM = dict(  # noqa: C408
    image_size=32,
    num_channels=32,
    num_res_blocks=1,
    channel_mult=(1, 2),
    attention_resolutions=(16, 8),
    num_head_channels=32,
    resblock_updown=True,
    use_scale_shift_norm=True,
)
TINY_FLUX = dict(  # noqa: C408
    in_channels=16,
    num_layers=2,
    num_single_layers=3,
    attention_head_dim=24,
    num_attention_heads=2,
    joint_attention_dim=32,
    pooled_projection_dim=20,
    axes_dims_rope=(8, 8, 8),
)


def _adm():
    return adm.make_model(**TINY_ADM, device="cpu", generator=torch.Generator().manual_seed(0)).eval()


def _flux():
    net = FluxTransformer(**TINY_FLUX, device="cpu", generator=torch.Generator().manual_seed(0))
    return FluxDenoiser(net).eval()


def _flux_cond(B: int = 2) -> dict:
    g = torch.Generator().manual_seed(1)
    return {
        "prompt_clip": torch.randn(B, 20, generator=g),
        "prompt_t5": torch.randn(B, 6, 32, generator=g),
        "guidance": 3.5,
    }


def _traced(fn):
    r"""Runs `fn` under a CPU profile and returns its spans `(name, start,
    end)` named `azula.*`, with the records kept meanwhile."""

    profiling.clear_records()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    events = prof.profiler.kineto_results.events()
    spans = [
        (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        for e in events
        if e.name().startswith("azula.")
    ]
    records = profiling.records()
    profiling.clear_records()
    return out, spans, records


def _named(spans, prefix):
    return [s for s in spans if s[0].startswith(prefix)]


def _inside(span, outer) -> bool:
    return any(o[1] <= span[1] and span[2] <= o[2] for o in outer)


def _adm_blocks(denoiser) -> int:
    unet = denoiser.backbone
    return len(unet.input_blocks) + 1 + len(unet.output_blocks)


def test_adm_spans_nest_in_exact_counts():
    denoiser = _adm()
    sampler = DDIMSampler(denoiser, steps=STEPS)
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(2))

    with torch.no_grad():
        _, spans, records = _traced(lambda: sampler(x))

    steps = _named(spans, "azula.sample.step")
    calls = _named(spans, "azula.denoise")
    blocks = _named(spans, "azula.block.")
    norms = _named(spans, "azula.ops.group_norm")
    attention = _named(spans, "azula.ops.attention")
    residuals = _named(spans, "azula.ops.residual_add")

    assert len(steps) == STEPS
    assert len(calls) == STEPS
    assert len(blocks) == _adm_blocks(denoiser) * STEPS
    assert all(_inside(c, steps) for c in calls)
    assert all(_inside(b, calls) for b in blocks)
    assert all(_inside(a, blocks) for a in attention)
    assert all(_inside(r, blocks) for r in residuals)
    # the output norm follows the last block: every other norm is a block's
    assert sum(_inside(n, blocks) for n in norms) == len(norms) - STEPS
    assert all(_inside(n, calls) for n in norms)

    assert {b[0] for b in blocks} == {
        "azula.block.Conv",
        "azula.block.ADMResBlock",
        "azula.block.ADMResBlock+ADMAttentionBlock",
        "azula.block.ADMResBlock+ADMAttentionBlock+ADMResBlock",
    }

    # one record per kernel span, in the order of the calls
    assert [r.op for r in records] == [s[0] for s in sorted(norms + attention + residuals, key=lambda s: s[1])]
    unet = denoiser.backbone
    resblocks = sum(isinstance(m, adm.backbone.ADMResBlock) for m in unet.modules())
    heads = sum(isinstance(m, adm.backbone.ADMAttentionBlock) for m in unet.modules())
    assert len(norms) == (2 * resblocks + heads + 1) * STEPS
    assert len(attention) == heads * STEPS
    assert len(residuals) == resblocks * STEPS
    assert {r.route for r in records} == {"plain"}


def test_adm_forward_records_one_residual_sum_a_resblock():
    # each ADMResBlock ends in one residual sum, with its convolutions'
    # biases: its record holds the route, the (B, HW, C) shape and the bytes
    # of skip, h and the output with the biases (two where the skip is a
    # convolution)
    denoiser = _adm()
    unet = denoiser.backbone
    blocks = [m for m in unet.modules() if isinstance(m, adm.backbone.ADMResBlock)]
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(2))

    shapes = []
    hooks = [b.register_forward_hook(lambda m, args, out: shapes.append((out.shape, m.skip is not None))) for b in blocks]
    try:
        with torch.no_grad():
            _, spans, records = _traced(lambda: unet(x, torch.tensor([10, 500])))
    finally:
        for hook in hooks:
            hook.remove()

    residuals = [r for r in records if r.op == "azula.ops.residual_add"]
    assert len(residuals) == len(blocks) == len(shapes)
    assert any(conv for _, conv in shapes) and not all(conv for _, conv in shapes)
    for record, (shape, conv) in zip(residuals, shapes):
        B, H, W, C = shape
        biases = 2 if conv else 1
        assert record.route == "plain"
        assert record.shape == (B, H * W, C)
        assert record.flops == 0
        assert record.bytes == 3 * B * H * W * C * 4 + biases * C * 4


def test_flux_spans_nest_in_exact_counts():
    denoiser = _flux()
    sampler = DDIMSampler(denoiser, steps=STEPS)
    x = torch.randn(2, 4, 4, 16, generator=torch.Generator().manual_seed(2))

    with torch.no_grad():
        _, spans, records = _traced(lambda: sampler(x, **_flux_cond()))

    steps = _named(spans, "azula.sample.step")
    calls = [s for s in spans if s[0] == "azula.denoise"]
    inputs = _named(spans, "azula.denoise.inputs")
    double = _named(spans, "azula.block.FluxTransformerBlock")
    single = _named(spans, "azula.block.FluxSingleTransformerBlock")
    attention = _named(spans, "azula.ops.attention")

    assert len(steps) == len(calls) == len(inputs) == STEPS
    assert len(double) == TINY_FLUX["num_layers"] * STEPS
    assert len(single) == TINY_FLUX["num_single_layers"] * STEPS
    assert len(attention) == len(double) + len(single)
    assert all(_inside(c, steps) for c in calls)
    assert all(_inside(i, calls) for i in inputs)
    assert not any(_inside(b, inputs) for b in double + single)
    assert all(_inside(b, calls) for b in double + single)
    assert all(_inside(a, double + single) for a in attention)

    L = 16 + 6
    H, D = TINY_FLUX["num_attention_heads"], TINY_FLUX["attention_head_dim"]
    assert [r.shape for r in records] == [(2, H, L, L, D)] * len(attention)


def test_multistep_sampler_opens_one_span_a_step():
    denoiser = _adm()
    sampler = zEABSampler(denoiser, steps=2)
    x = torch.randn(1, 32, 32, 3, generator=torch.Generator().manual_seed(2))

    with torch.no_grad():
        _, spans, _ = _traced(lambda: sampler(x))

    steps = _named(spans, "azula.sample.step")
    calls = _named(spans, "azula.denoise")
    assert len(steps) == len(calls) == 2
    assert all(_inside(c, steps) for c in calls)


def _randn(*shape, seed=0):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


def _attention_case():
    q, k, v = _randn(2, 3, 16, 32), _randn(2, 3, 24, 32, seed=1), _randn(2, 3, 24, 32, seed=2)
    work = ((2, 3, 16, 24, 32), 4 * 2 * 3 * 16 * 24 * 32, 4 * 2 * 3 * (16 * 32 * 2 + 24 * 32 * 2))
    return "azula.ops.attention", lambda: dot_product_attention(q, k, v), work


def _self_attention_bf16_case():
    q = _randn(1, 2, 64, 64).bfloat16()
    work = ((1, 2, 64, 64, 64), 4 * 2 * 64 * 64 * 64, 2 * 2 * 64 * 4 * 64)
    return "azula.ops.attention", lambda: dot_product_attention(q, q, q), work


def _group_norm_case():
    x, scale, bias = _randn(2, 4, 4, 8), _randn(8), _randn(8)
    mod_scale, mod_shift = _randn(2, 8, seed=3), _randn(2, 8, seed=4)
    work = ((2, 16, 8), 0, 2 * 2 * 4 * 4 * 8 * 4 + 2 * 8 * 4 + 2 * 2 * 8 * 4)
    return "azula.ops.group_norm", lambda: group_norm_silu(x, 2, 1e-5, scale, bias, mod_scale, mod_shift), work


def _group_norm_bare_case():
    x = _randn(2, 16, 8).bfloat16()
    return "azula.ops.group_norm", lambda: group_norm(x, 4), ((2, 16, 8), 0, 2 * 2 * 16 * 8 * 2)


# the ops whose work no metric reads yet: a span, and no record


def _group_stats_case():
    x = _randn(2, 16, 8)
    return "azula.ops.group_stats", lambda: group_stats(x, 4), None


def _conv3x3_case():
    x, w = _randn(1, 4, 4, 8), _randn(3, 3, 8, 16, seed=1)
    return "azula.ops.conv3x3", lambda: conv3x3(x, w), None


def _fused_msa_case():
    qkv, theta = _randn(1, 8, 3 * 2 * 16), _randn(8, 16, seed=1)
    return "azula.ops.fused_msa", lambda: fused_msa_attention(qkv, 2, theta), None


def _residual_add_case():
    skip, h, b0, b1 = _randn(2, 4, 4, 8), _randn(2, 4, 4, 8, seed=1), _randn(8, seed=2), _randn(8, seed=3)
    work = ((2, 16, 8), 0, 3 * 2 * 16 * 8 * 4 + 2 * 8 * 4)
    return "azula.ops.residual_add", lambda: residual_add(skip, h, b0, b1), work


CASES = {
    "attention": _attention_case,
    "attention_bf16": _self_attention_bf16_case,
    "group_norm_silu": _group_norm_case,
    "group_norm": _group_norm_bare_case,
    "residual_add": _residual_add_case,
    "group_stats": _group_stats_case,
    "conv3x3": _conv3x3_case,
    "fused_msa": _fused_msa_case,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_record_holds_the_calls_work(case):
    op, call, work = CASES[case]()

    with torch.no_grad():
        _, spans, records = _traced(call)

    assert [s[0] for s in spans] == [op]
    if work is None:
        assert records == []
        return

    shape, flops, nbytes = work
    assert len(records) == 1
    (record,) = records
    assert record.op == op and record.route == "plain"
    assert record.shape == shape
    assert record.flops == flops
    assert record.bytes == nbytes


def _refuse(*args, **kwargs):
    raise AssertionError("a region was opened with no profiler recording")


def test_no_profiler_opens_no_region_and_keeps_nothing(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    profiling.clear_records()

    sampler = DDIMSampler(_adm(), steps=2)
    with torch.no_grad():
        sampler(torch.randn(1, 32, 32, 3))
        DDIMSampler(_flux(), steps=1)(torch.randn(1, 4, 4, 16), **_flux_cond(1))
        for case in CASES.values():
            case()[1]()

    assert profiling.records() == []
    assert profiling.annotate("azula.sample.step") is profiling.annotate("azula.denoise")


@pytest.mark.parametrize("traced", [False, True])
def test_compiled_denoiser_matches_eager(traced):
    denoiser = _flux()
    x, t = torch.randn(2, 4, 4, 16, generator=torch.Generator().manual_seed(5)), torch.tensor(0.6)
    cond = _flux_cond()

    with torch.no_grad():
        want = denoiser(x, t, **cond).mean
        compiled = torch.compile(denoiser, backend="eager")
        if traced:
            # the compiled code opens no span and keeps no record
            got, spans, records = _traced(lambda: compiled(x, t, **cond).mean)
            assert not _named(spans, "azula.block.") and not records
        else:
            got = compiled(x, t, **cond).mean

    torch._dynamo.reset()
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-6)


def test_annotate_keeps_the_route_of_a_launch(monkeypatch):
    r"""A kernel span's route is the `LAUNCHES` names that changed within
    it (a launch stood in for by a count, as on the CPU no kernel runs)."""

    from azula_tpu_torch.ops import _build

    def work(x):
        return tuple(x.shape), 1, 2

    profiling.clear_records()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.annotate("azula.ops.test", work, torch.ones(3)):
            _build.LAUNCHES["attention_fwd_max_free"] += 1
    records = profiling.records()
    profiling.clear_records()
    _build.LAUNCHES["attention_fwd_max_free"] -= 1

    assert records == [profiling.Record("azula.ops.test", "attention_fwd_max_free", (3,), 1, 2)]


def test_two_profiler_sessions_keep_a_bounded_list(monkeypatch):
    r"""Records accumulate across profiler sessions, newest last, and the
    list keeps only the newest of them."""

    assert profiling._RECORDS.maxlen == profiling._KEEP
    monkeypatch.setattr(profiling, "_RECORDS", collections.deque(maxlen=4))
    _, gn, _ = CASES["group_norm"]()
    _, attention, _ = CASES["attention"]()

    with torch.no_grad():
        for call in (gn, attention):
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                for _ in range(3):
                    call()

    assert [r.op for r in profiling.records()] == ["azula.ops.group_norm"] + ["azula.ops.attention"] * 3
