r"""The GroupNorm and statistics kernels' plan (`_gn_plan` in
`azula_tpu_torch.ops.norm`) and the plain versions at the kernels' rounding
points, on the CPU.

The plan is held at every GroupNorm shape of the ADM-256 forward, unet32's
three and the JAX package's production shapes of the statistics kernel
(`tests/test_ops_tpu.py`), in bf16 and float32, for each kernel: its blocks cover every row
and channel of x once, the grid is a whole number of clusters, a cluster's
blocks share one (batch row, band), and a block's shared memory fits the
H100's 227 KB, with room for the rows the kernels stream. The kernels' own launch takes the plan as given, so the
CUDA sources are held to the same arithmetic by `chip_smoke.py` on the card
(`azula_group_norm_shared_bytes` against `_shared_bytes`).

The plain versions repeat the kernels' rounding points (sums per block of
`rows` rows, folded in block order) and are held against the JAX package's
XLA GroupNorm (`_gn_fused_xla`), its pilot statistics (`_stats_pilot`) and
its TPU statistics kernel (`_stats_pallas`, interpret mode). Tolerances as
`tests/test_torch_ops.py` and `tests/test_torch_norm_stats.py`: float32
outputs within 5e-6 of max |reference|; statistics, mean within 1e-3
absolute and var within 1e-5 relative; |mean| / std = 1e4 within 5e-3
absolute (the rounding of x itself).
"""

import hashlib
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  one thread a process

from jax.experimental.pallas import tpu as pltpu

from azula_tpu.ops import norm as jnorm
from azula_tpu_torch.ops import _build
from azula_tpu_torch.ops import norm as tnorm

# (HW, C) of the ADM-256 forward's GroupNorms (batch 8, 32 groups), as
# chip_smoke.py's phase 3 records them
ADM = [
    (64, 1024), (256, 1024), (1024, 512), (65536, 256), (64, 2048), (256, 512), (256, 1536), (256, 2048),
    (1024, 1024), (1024, 1536), (4096, 256), (4096, 512), (4096, 768), (4096, 1024), (16384, 256), (16384, 512),
    (16384, 768), (65536, 512),
]
UNET32 = [(256, 1024, 64), (256, 256, 128), (256, 64, 256)]
PRODUCTION = [
    ((8, 65536, 256), 32), ((8, 16384, 512), 32), ((2, 4096, 1024), 32), ((4, 9216, 384), 32),
    ((8, 66049, 256), 32), ((2, 4096, 192), 24),
]
# (B, HW, C) of the GroupNorms (32 groups each) of the paths of
# `chip_smoke.py`'s phases 39-42: SD 2's UNet at 96 x 96 latents under
# batched CFG (batch 8), SD 1's at 64 x 64 (batch 4), the SD VAE's decode to
# 768 x 768 (batch 4), EDM's ImageNet-64 network (batch 64; groups of
# min(32, C // 4): 42 channels at C = 1344, a 168-byte bf16 band row; 30 at
# C = 960) and the EDM2 decode to 512 x 512 (batch 8), as
# `test_new_paths_shapes_are_recorded` records them on the meta device
SD2_768 = [
    (8, HW, C) for HW, C in (
        (144, 1280), (144, 2560), (576, 640), (576, 1280), (576, 1920), (576, 2560), (2304, 320), (2304, 640),
        (2304, 960), (2304, 1280), (2304, 1920), (9216, 320), (9216, 640), (9216, 960),
    )
]
SD1_512 = [
    (4, HW, C) for HW, C in (
        (64, 1280), (64, 2560), (256, 640), (256, 1280), (256, 1920), (256, 2560), (1024, 320), (1024, 640),
        (1024, 960), (1024, 1280), (1024, 1920), (4096, 320), (4096, 640), (4096, 960),
    )
]
SD_VAE_768 = [
    (4, HW, C) for HW, C in ((9216, 512), (36864, 512), (147456, 256), (147456, 512), (589824, 128), (589824, 256))
]
EDM64 = [
    (64, HW, C) for HW, C in (
        (64, 576), (64, 768), (64, 1344), (64, 1536), (256, 384), (256, 576), (256, 768), (256, 960), (256, 1152),
        (256, 1344), (1024, 192), (1024, 384), (1024, 576), (1024, 768), (1024, 960), (4096, 192), (4096, 384),
        (4096, 576),
    )
]
EDM2_VAE_512 = [
    (8, HW, C) for HW, C in ((4096, 512), (16384, 512), (65536, 256), (65536, 512), (262144, 128), (262144, 256))
]
NEW_PATHS = {"sd2_768": SD2_768, "sd1_512": SD1_512, "sd_vae_768": SD_VAE_768, "edm64": EDM64, "edm2_vae_512": EDM2_VAE_512}
# (B, HW, C) of the single-group GroupNorms of `chip_smoke.py`'s phases 44
# and 45: CC12M-1's at 256 x 256 under batched CFG (batch 16; after every
# convolution, and the attention pre-norms) and yfcc_2's attention pre-norms
# at 512 x 512 (batch 4), as `test_wide_paths_shapes_are_recorded` records
# them; the groups of 512, 1024 and 2048 channels span one, two and four
# bands of 512
CC12M_256 = [
    (16, HW, C) for HW, C in (
        (16, 1024), (64, 512), (64, 1024), (256, 512), (1024, 256), (1024, 512), (4096, 256), (16384, 128),
        (16384, 256), (65536, 128),
    )
]
YFCC2_512 = [(4, HW, C) for HW, C in ((16, 2048), (64, 1024), (64, 2048), (256, 1024))]
WIDE_PATHS = {"cc12m_256": CC12M_256, "yfcc2_512": YFCC2_512}
WIDE = [(shape, 1) for shape in CC12M_256 + YFCC2_512] + [((2, 1000, 1536), 1), ((2, 256, 4096), 2), ((1, 64, 8192), 1)]

CASES = [((8, HW, C), 32) for HW, C in ADM] + [(shape, 16) for shape in UNET32] + PRODUCTION
CASES += [(shape, 32) for shape in dict.fromkeys(sum(NEW_PATHS.values(), [])) if (shape, 32) not in CASES]


def _rel_err(got, want) -> float:
    got = got.double().numpy()
    want = np.asarray(jnp.asarray(want, dtype=jnp.float32), dtype=np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _blocks(plan, C):
    r"""The (band, rank) of each block along x of the launch's grid."""

    return [divmod(bx, plan.cluster) for bx in range(C // plan.band * plan.cluster)]


@pytest.mark.parametrize("stats", [False, True], ids=["group_norm", "group_stats"])
@pytest.mark.parametrize("itemsize", [2, 4], ids=["bfloat16", "float32"])
@pytest.mark.parametrize("shape, groups", CASES, ids=[f"{s}-G{g}" for s, g in CASES])
def test_plan_covers_the_tensor_once(shape, groups, itemsize, stats):
    B, HW, C = shape
    plan = tnorm._gn_plan(B, HW, C, groups, itemsize, stats)

    # bands of whole groups that divide C; at most 16 blocks a cluster; a
    # block keeps its rows, or two passes of its threads' rows at least
    assert plan.band % (C // groups) == 0 and C % plan.band == 0 and plan.band <= 512
    assert 1 <= plan.cluster <= 16 and 0 < plan.resident <= plan.rows and 0 < plan.stage <= plan.rows
    twice = 2 * tnorm._row_threads(plan.band, itemsize)
    assert plan.resident >= min(plan.rows, twice) and plan.stage >= min(plan.rows, twice)

    # the grid (bands * cluster, B) is a whole number of clusters, and the
    # blocks of one cluster (consecutive along x, one grid row) share one
    # (batch row, band)
    blocks = _blocks(plan, C)
    assert len(blocks) % plan.cluster == 0
    for first in range(0, len(blocks), plan.cluster):
        assert len({band for band, _ in blocks[first:first + plan.cluster]}) == 1
        assert [rank for _, rank in blocks[first:first + plan.cluster]] == list(range(plan.cluster))

    # every row and channel of a batch row once, every block holding rows
    count = np.zeros((HW, C), np.int8)
    for band, rank in blocks:
        assert rank * plan.rows < HW
        count[rank * plan.rows:(rank + 1) * plan.rows, band * plan.band:(band + 1) * plan.band] += 1
    assert (count == 1).all()

    # the block's shared memory, as the kernel computes it, on the H100
    assert plan.smem == tnorm._shared_bytes(plan.band, plan.resident, itemsize) <= 232448


@pytest.mark.parametrize(
    "shape, groups, itemsize, band",
    [
        ((8, 65536, 256), 32, 2, 64),  # 128 bytes a row: whole lines of x
        ((8, 4096, 512), 32, 2, 64),
        ((8, 4096, 256), 32, 2, 32),  # 128-byte bands give 64 blocks: half a line a row gives a wave
        ((2, 4096, 192), 24, 2, 64),
        ((8, 4096, 768), 32, 2, 96),  # 48-byte groups: the narrowest band of 128 bytes or more
        ((8, 65536, 256), 32, 4, 32),
        ((256, 256, 128), 16, 2, 128),  # unet32: the batch fills a wave, whole rows up to 512 bytes
        ((256, 64, 256), 16, 2, 256),
        ((4, 1024, 16), 16, 4, 16),  # the tiny UNet: the whole row
    ],
)
def test_plan_bands(shape, groups, itemsize, band):
    assert tnorm._gn_plan(*shape, groups, itemsize).band == band


def test_plan_clusters_and_residency():
    # ADM's largest shape: 16 blocks a unit of 8 MB, 218 KB of each kept,
    # the rest read again; design (a) for comparison, one group a band
    # resident on clusters of 8
    plan = tnorm._gn_plan(8, 65536, 256, 32, 2)
    assert (plan.band, plan.cluster, plan.rows, plan.resident) == (64, 16, 4096, 1746)
    assert tnorm._gn_plan(8, 65536, 256, 32, 2) is plan  # cached per shape
    a = tnorm._plan(65536, 8, 8, 2)
    assert (a.band, a.cluster, a.resident) == (8, 8, 8192) and a.smem <= 232448

    # a wave of blocks: ADM's small calls take one cluster of one block
    # per 128-byte band, (8, 1024, 512) two
    assert tnorm._gn_plan(8, 64, 1024, 32, 2).cluster == 1
    assert tnorm._gn_plan(8, 1024, 512, 32, 2).cluster == 2

    # a unit above 96 KB takes two blocks, which share an SM: ADM's
    # (8, 1024, 1024) and (8, 1024, 1536), unet32's (256, 1024, 64); below
    # it, one block
    for shape, groups in (((8, 1024, 1024), 32), ((8, 1024, 1536), 32), ((256, 1024, 64), 16)):
        plan = tnorm._gn_plan(*shape, groups, 2)
        assert plan.cluster == 2 and plan.resident == plan.rows == shape[1] // 2
    assert tnorm._gn_plan(256, 256, 128, 16, 2).cluster == 1

    # the statistics kernel keeps no rows and takes no such split
    assert tnorm._gn_plan(256, 1024, 64, 16, 2, stats=True).cluster == 1
    assert tnorm._gn_plan(8, 1024, 1024, 32, 2, stats=True).cluster == 1

    # a group wider than a band spans bands: 1024 channels as two bands of
    # 512 on one cluster, a block of all 64 rows for each band
    plan = tnorm._gn_plan(1, 64, 1024, 1, 4)
    assert (plan.band, plan.cluster, plan.rows) == (512, 2, 64)


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("rows", [None, 4096, 1000, 77])
def test_group_norm_plain_blocks_match_jax(rows, silu):
    rng = np.random.default_rng(20)
    x = (rng.standard_normal((2, 4096, 64)) * 2 + 0.5).astype(np.float32)
    P = (1 + 0.3 * rng.standard_normal((2, 64))).astype(np.float32)
    Q = (0.3 * rng.standard_normal((2, 64))).astype(np.float32)

    want = jnorm._gn_fused_xla(jnp.asarray(x), jnp.asarray(P)[:, None], jnp.asarray(Q)[:, None], 16, 1e-5, silu)
    got = tnorm._group_norm_plain(
        torch.from_numpy(x), torch.from_numpy(P), torch.from_numpy(Q), 16, 1e-5, silu, rows
    )

    assert _rel_err(got, want) <= 5e-6


@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_plain_blocks_exact_at_large_mean(silu):
    # |mean| / std = 1e4 over blocks of 300 rows: each block's sums are of
    # x - K, so they add without cancellation
    rng = np.random.default_rng(21)
    x = (1e4 + rng.standard_normal((2, 2048, 32))).astype(np.float32)
    P, Q = np.ones((2, 32), np.float32), np.zeros((2, 32), np.float32)

    want = jnorm._gn_fused_xla(jnp.asarray(x), jnp.asarray(P)[:, None], jnp.asarray(Q)[:, None], 8, 1e-5, silu)
    got = tnorm._group_norm_plain(torch.from_numpy(x), torch.from_numpy(P), torch.from_numpy(Q), 8, 1e-5, silu, 300)

    assert np.abs(got.double().numpy() - np.asarray(want, np.float64)).max() <= 5e-3
    assert np.abs(np.asarray(want)).max() > 0.5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape, groups", [((2, 4096, 192), 24), ((4, 1024, 16), 16), ((2, 4096, 64), 16)])
def test_stats_plain_at_the_plan_matches_jax(shape, groups, dtype):
    # the plan's blocks (8, 1 and 8 of them here), 100 + 3 N inputs
    rng = np.random.default_rng(22)
    x = (100.0 + 3.0 * rng.standard_normal(shape)).astype(np.float32)
    if dtype == "bfloat16":  # rounded as JAX's bf16 input would be
        x = np.array(jnp.asarray(x, dtype=jnp.bfloat16).astype(jnp.float32))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))

    got_mean, got_var = tnorm.group_stats(xt, groups, "plain")
    want_mean, want_var = jnorm._stats_pilot(jnp.asarray(x), groups)

    assert np.abs(got_mean.double().numpy() - np.asarray(want_mean, np.float64)).max() < 1e-3
    assert (np.abs(got_var.double().numpy() - np.asarray(want_var, np.float64)) / np.asarray(want_var)).max() < 1e-5


@pytest.mark.parametrize("rows", [1024, 700, 512])
def test_stats_plain_blocks_match_pallas_kernel(rows):
    # JAX's TPU kernel in interpret mode at two tiles of 1024 rows against
    # the plain version's Chan fold over blocks of `rows` rows
    rng = np.random.default_rng(23)
    x = (100.0 + 3.0 * rng.standard_normal((2, 2048, 512))).astype(np.float32)
    assert 2048 // jnorm._stats_block(2048, 512) == 2

    with pltpu.force_tpu_interpret_mode():
        want_mean, want_var = jax.block_until_ready(jnorm._stats_pallas(jnp.asarray(x), 32))

    mean, var = tnorm._stats_kernel_plain(torch.from_numpy(x), 32, rows)
    assert np.abs(mean.double().numpy() - np.asarray(want_mean, np.float64)).max() < 1e-3
    assert (np.abs(var.double().numpy() - np.asarray(want_var, np.float64)) / np.asarray(want_var)).max() < 1e-5


def test_forward_only_launches_directly_without_grad():
    # no autograd node where nothing can record one; the node, and its
    # raise, where an input requires grad
    launch = _build.forward_only("toy", "ROADMAP X")(lambda x, s: x * s)

    assert launch(torch.ones(3), 2.0).grad_fn is None
    with torch.no_grad():
        assert launch(torch.ones(3, requires_grad=True), 2.0).grad_fn is None

    y = launch(torch.ones(3, requires_grad=True), 2.0)
    assert y.grad_fn is not None
    with pytest.raises(NotImplementedError, match="the toy kernel has no backward yet"):
        y.sum().backward()


def test_new_paths_shapes_are_recorded(monkeypatch):
    # the shapes above are those that the paths' modules hand to the
    # GroupNorm on the meta device (no arithmetic runs)
    from azula_tpu_torch.models import sd
    from azula_tpu_torch.models.autoencoder import AutoencoderKL
    from azula_tpu_torch.models.edm.backbone import DhariwalUNet, EDMPrecond

    calls = []

    def spy(x, P, Q, groups, eps, silu, implementation):
        calls.append((tuple(x.shape), groups))
        return x

    monkeypatch.setattr(tnorm, "_gn_forward", spy)

    def meta(*shape):
        return torch.empty(shape, device="meta")

    edm64 = EDMPrecond(DhariwalUNet(64, 3, 3, label_dim=1000, device="meta"))
    vae = AutoencoderKL(device="meta")
    paths = {
        "sd2_768": (lambda: sd.make_backbone("sd_2", device="meta")(meta(8, 96, 96, 4), 0, meta(8, 77, 1024)), 61),
        "sd1_512": (lambda: sd.make_backbone("sd_1.5", device="meta")(meta(4, 64, 64, 4), 0, meta(4, 77, 768)), 61),
        "sd_vae_768": (lambda: vae.decode(meta(4, 96, 96, 4)), 30),
        "edm64": (lambda: edm64(meta(64, 64, 64, 3), 1.0, class_labels=meta(64, 1000)), 95),
        "edm2_vae_512": (lambda: vae.decode(meta(8, 64, 64, 4)), 30),
    }
    with torch.no_grad():
        for name, (run, n) in paths.items():
            calls.clear()
            run()
            assert len(calls) == n, name
            assert sorted({shape for shape, _ in calls}) == sorted(NEW_PATHS[name]), name
            assert all(groups == 32 for _, groups in calls), name


# the new paths' groups that are not a multiple of 8 channels (EDM's 42 and
# SD's and EDM's 30), and the widest
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 64, 1344), (64, 256, 960), (8, 2304, 960), (8, 144, 2560)], ids=str)
def test_group_norm_plain_at_new_shapes_matches_jax(shape, dtype):
    B, HW, C = shape
    rng = np.random.default_rng(24)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    if dtype == "bfloat16":  # rounded as JAX's bf16 input would be
        x = np.array(jnp.asarray(x, dtype=jnp.bfloat16).astype(jnp.float32))
    P = (1 + 0.3 * rng.standard_normal((B, C))).astype(np.float32)
    Q = (0.3 * rng.standard_normal((B, C))).astype(np.float32)
    jdtype, tdtype = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]

    plan = tnorm._gn_plan(B, HW, C, 32, 4 if dtype == "float32" else 2)
    want = jnorm._gn_fused_xla(
        jnp.asarray(x, dtype=jdtype), jnp.asarray(P)[:, None], jnp.asarray(Q)[:, None], 32, 1e-5, False
    )
    got = tnorm._group_norm_plain(
        torch.from_numpy(x).to(tdtype), torch.from_numpy(P), torch.from_numpy(Q), 32, 1e-5, False
    )

    assert got.dtype == tdtype and plan.band % (C // 32) == 0
    assert _rel_err(got.float(), want) <= (5e-6 if dtype == "float32" else 1e-2)


# --- groups wider than 256 channels ------------------------------------------


def test_plans_at_the_listed_shapes_are_unchanged():
    # the plans of every shape above, each dtype and kernel, as they were
    # before groups could span bands (a digest of their tuples)
    plans = [
        tuple(tnorm._gn_plan(*shape, groups, itemsize, stats))
        for shape, groups in CASES for itemsize in (2, 4) for stats in (False, True)
    ]
    assert len(plans) == 324
    assert hashlib.sha256(repr(plans).encode()).hexdigest() == (
        "7eb204c9a1d3f227869ee7a9ea7f942ce20c4485a32ff8463ecaf0dc8662f9f3"
    )


def _wide_blocks(plan, C, cpg):
    r"""The (band, row block, rank) of each block along x of the launch's
    grid where a group spans `span` bands: cluster k is group k, rank
    j * nr + r takes band j of the group's rows r."""

    span = tnorm._span(plan.band, cpg)
    nr = plan.cluster // span
    blocks = []
    for bx in range(C // (plan.band * span) * plan.cluster):
        k, rank = divmod(bx, plan.cluster)
        j, r = divmod(rank, nr)
        blocks.append((k * span + j, r, rank))
    return blocks


@pytest.mark.parametrize("stats", [False, True], ids=["group_norm", "group_stats"])
@pytest.mark.parametrize("itemsize", [2, 4], ids=["bfloat16", "float32"])
@pytest.mark.parametrize("shape, groups", WIDE, ids=[f"{s}-G{g}" for s, g in WIDE])
def test_wide_plan_covers_the_tensor_once(shape, groups, itemsize, stats):
    B, HW, C = shape
    cpg = C // groups
    plan = tnorm._gn_plan(B, HW, C, groups, itemsize, stats)
    span = tnorm._span(plan.band, cpg)

    # bands of at most 512 channels that divide C: whole groups, or a
    # group's span bands; whole clusters of at most 16 blocks, span of them
    # a row block
    assert plan.band <= 512 and C % plan.band == 0
    assert plan.band % cpg == 0 if cpg <= 512 else (span * plan.band == cpg and span > 1)
    assert 1 <= plan.cluster <= 16 and plan.cluster % span == 0
    assert 0 < plan.resident <= plan.rows and 0 < plan.stage <= plan.rows
    twice = 2 * tnorm._row_threads(plan.band, itemsize)
    assert plan.resident >= min(plan.rows, twice) and plan.stage >= min(plan.rows, twice)

    # every row and channel of a batch row once, every block holding rows;
    # the blocks of a cluster share one group (or one band of whole groups)
    count = np.zeros((HW, C), np.int8)
    blocks = _wide_blocks(plan, C, cpg)
    for first in range(0, len(blocks), plan.cluster):
        cluster = blocks[first:first + plan.cluster]
        assert len({band * plan.band // max(cpg, plan.band) for band, _, _ in cluster}) == 1
        assert [rank for _, _, rank in cluster] == list(range(plan.cluster))
    for band, r, _ in blocks:
        assert r * plan.rows < HW
        count[r * plan.rows:(r + 1) * plan.rows, band * plan.band:(band + 1) * plan.band] += 1
    assert (count == 1).all()

    # the block's shared memory, as the kernel computes it, on the H100
    assert plan.smem == tnorm._shared_bytes(plan.band, plan.resident, itemsize, span) <= 232448


def test_wide_plans():
    # yfcc_2's widest pre-norm: four bands of 512, a block each (16 rows);
    # CC12M-1's 1024-channel groups at 8 x 8: two bands, a block each;
    # yfcc_2's 16 x 16 level: two bands of two blocks; a group of 8192
    # channels: 16 bands, the most a cluster holds
    assert tnorm._gn_plan(4, 16, 2048, 1, 2)[:3] == (512, 4, 16)
    assert tnorm._gn_plan(16, 64, 1024, 1, 2)[:3] == (512, 2, 64)
    assert tnorm._gn_plan(4, 256, 1024, 1, 2)[:3] == (512, 4, 128)
    assert tnorm._gn_plan(1, 64, 8192, 1, 2)[:2] == (512, 16)
    # 1536 channels: three bands of four blocks; 1030 (no divisor near
    # 512): five of 206
    assert tnorm._gn_plan(2, 1000, 1536, 1, 2)[:2] == (512, 3 * 4)
    assert tnorm._gn_plan(2, 256, 1030, 1, 2)[:2] == (206, 10)
    # groups of at most 512 channels keep a band of whole groups
    assert tnorm._gn_plan(16, 1024, 512, 1, 2).band == 512
    assert tnorm._gn_plan(16, 65536, 128, 1, 2)[:3] == (128, 16, 4096)


def test_kernels_refuse_groups_past_a_cluster():
    # 17 bands of 512 (or 1031 channels, whose widest divisor up to 512 is
    # 1) do not fit a cluster of 16: the wrappers raise before any launch
    with pytest.raises(ValueError, match="at most 16 bands"):
        tnorm._check_groups(1, 64, 17 * 512, 1, 2)
    with pytest.raises(ValueError, match="at most 16 bands"):
        tnorm._check_groups(1, 64, 1031, 1, 4)
    tnorm._check_groups(1, 64, 16 * 512, 1, 2)  # the widest taken


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 1024, 1024), (4, 16, 2048), (3, 100, 1536)], ids=str)
def test_group_norm_plain_at_wide_plans_matches_jax(shape, dtype):
    # the plain version at the wide plan's block split (its rows) against
    # JAX's XLA GroupNorm, one group a batch row, with an affine
    B, HW, C = shape
    rng = np.random.default_rng(30)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    if dtype == "bfloat16":  # rounded as JAX's bf16 input would be
        x = np.array(jnp.asarray(x, dtype=jnp.bfloat16).astype(jnp.float32))
    P = np.broadcast_to(1 + 0.2 * rng.standard_normal((1, C)), (B, C)).astype(np.float32)
    Q = np.broadcast_to(0.2 * rng.standard_normal((1, C)), (B, C)).astype(np.float32)
    jdtype, tdtype = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]

    plan = tnorm._gn_plan(B, HW, C, 1, 4 if dtype == "float32" else 2)
    want = jnorm._gn_fused_xla(jnp.asarray(x, dtype=jdtype), jnp.asarray(P)[:, None], jnp.asarray(Q)[:, None], 1, 1e-5, False)
    got = tnorm._group_norm_plain(torch.from_numpy(x).to(tdtype), torch.from_numpy(P), torch.from_numpy(Q), 1, 1e-5, False)

    assert tnorm._span(plan.band, C) > 1 and got.dtype == tdtype
    assert _rel_err(got.float(), want) <= (5e-6 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("shape", [(2, 1024, 1024), (2, 512, 2048)], ids=str)
def test_stats_plain_at_wide_plans_matches_pallas_kernel(shape):
    # JAX's TPU statistics kernel in interpret mode (one group of C
    # channels, its own tiles) against the plain version's Chan fold over
    # the wide plan's blocks, 100 + 3 N inputs
    B, HW, C = shape
    rng = np.random.default_rng(31)
    x = (100.0 + 3.0 * rng.standard_normal(shape)).astype(np.float32)
    assert jnorm.stats_kernel_eligible(shape)

    with pltpu.force_tpu_interpret_mode():
        want_mean, want_var = jax.block_until_ready(jnorm._stats_pallas(jnp.asarray(x), 1))

    plan = tnorm._gn_plan(B, HW, C, 1, 4, stats=True)
    mean, var = tnorm._stats_kernel_plain(torch.from_numpy(x), 1, plan.rows)
    assert tnorm._span(plan.band, C) > 1
    assert np.abs(mean.double().numpy() - np.asarray(want_mean, np.float64)).max() < 1e-3
    assert (np.abs(var.double().numpy() - np.asarray(want_var, np.float64)) / np.asarray(want_var)).max() < 1e-5


@pytest.mark.parametrize("kernel", ["group_norm", "group_stats"])
def test_plain_at_a_whole_image_group_exact_at_large_mean(kernel):
    # CC12M-1's first level: one group of 65536 rows x 128 channels (8.4M
    # elements), |mean| / std = 1e4, against float64 of the same float32
    # values, at the plan's 16 blocks of 4096 rows
    rng = np.random.default_rng(32)
    x = (1e4 + rng.standard_normal((2, 65536, 128))).astype(np.float32)
    xt = torch.from_numpy(x)
    var64, mean64 = torch.var_mean(xt.double(), dim=(1, 2), keepdim=True, correction=0)
    plan = tnorm._gn_plan(2, 65536, 128, 1, 4, stats=kernel == "group_stats")
    assert plan.cluster == 16 and plan.rows == 4096

    if kernel == "group_norm":
        P, Q = torch.ones(2, 128), torch.zeros(2, 128)
        got = tnorm._group_norm_plain(xt, P, Q, 1, 1e-5, False, plan.rows)
        assert (got.double() - (xt.double() - mean64) / torch.sqrt(var64 + 1e-5)).abs().max() <= 5e-3
    else:
        mean, var = tnorm._stats_kernel_plain(xt, 1, plan.rows)
        assert (mean.double().flatten() - mean64.flatten()).abs().max() < 1e-3
        assert ((var.double().flatten() - var64.flatten()).abs() / var64.flatten()).max() < 1e-5


def test_wide_paths_shapes_are_recorded(monkeypatch):
    # the shapes above are those that CC12M-1 (135 calls a call, 111
    # without affine) and yfcc_2 (12, affine) hand to the GroupNorm on the
    # meta device (no arithmetic runs)
    from azula_tpu_torch.models import vdm

    calls = []

    def spy(x, P, Q, groups, eps, silu, implementation):
        calls.append((tuple(x.shape), groups))
        return x

    monkeypatch.setattr(tnorm, "_gn_forward", spy)

    def meta(*shape):
        return torch.empty(shape, device="meta")

    paths = {
        "cc12m_256": (lambda: vdm.make_model("cc12m_1", device="meta").backbone(meta(16, 256, 256, 3), meta(16), meta(16, 512)), 135),
        "yfcc2_512": (lambda: vdm.make_model("yfcc_2", device="meta").backbone(meta(4, 512, 512, 3), meta(4)), 12),
    }
    with torch.no_grad():
        for name, (run, n) in paths.items():
            calls.clear()
            run()
            assert len(calls) == n, name
            assert sorted({shape for shape, _ in calls}) == sorted(WIDE_PATHS[name]), name
            assert all(groups == 1 for _, groups in calls), name
