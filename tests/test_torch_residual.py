r"""`ops.residual_add`, the residual sum with the convolutions' biases: the
plain version against a float64 composition, its gradients against autograd
through the plain expression, its dtypes and refusals; and, on the card
(`-m card`), the kernel `csrc/residual.cu` against the plain version for
every input (strided, misaligned, any C, mixed dtypes), and its launches in
an ADM-256 forward:

    python -m pytest tests/test_torch_residual.py -q -m card --noconftest
"""

import math
import pytest
import torch
import torch_cpu  # noqa: F401  one thread a process

from azula_tpu_torch.ops import _build, residual_add
from azula_tpu_torch.ops.residual import _residual_add_plain

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def card():
    r"""Skips the test where no CUDA card is present (decided when the test
    runs, never at import)."""

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")


def _inputs(shape, dtype, biases: int, seed: int = 0, device="cpu"):
    g = torch.Generator(device).manual_seed(seed)
    C = shape[-1]
    skip = torch.randn(shape, generator=g, device=device).to(dtype)
    h = torch.randn(shape, generator=g, device=device).to(dtype)
    bs = [torch.randn(C, generator=g, device=device).to(dtype) for _ in range(biases)]
    return skip, h, bs


def _ulp(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    r"""One unit in the last place of `dtype` at each |x| (float64)."""

    mantissa = {torch.float32: 23, torch.bfloat16: 7}[dtype]
    tiny = torch.finfo(dtype).tiny
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(tiny))) - mantissa)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("biases", [0, 1, 2])
@pytest.mark.parametrize("C", [6, 42, 256, 512, 1024])
def test_plain_matches_float64(dtype, biases, C):
    # one rounding of a float32 sum: within half an ulp of the dtype of the
    # exact sum, plus the float32 sum's own error (a few float32 ulps of the
    # summed magnitudes), which for bf16 may tip a tie the other way
    dtype = DTYPES[dtype]
    skip, h, bs = _inputs((2, 3, 5, C), dtype, biases, seed=C + biases)

    got = residual_add(skip, h, *bs)
    assert got.dtype == dtype and got.shape == h.shape

    want = skip.double() + h.double() + sum(b.double() for b in bs)
    scale = skip.double().abs() + h.double().abs() + sum(b.double().abs() for b in bs)
    bound = 0.5 * _ulp(want, dtype) + 4 * 2.0**-24 * scale
    assert ((got.double() - want).abs() <= bound).all()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rounds_once(dtype):
    # the sum is taken in float32, the biases first, and rounded once: equal
    # to that float32 expression rounded, where bf16 sums rounded at each
    # step differ
    dtype = DTYPES[dtype]
    skip, h, (b0, b1) = _inputs((4, 8, 8, 64), dtype, 2, seed=7)

    got = residual_add(skip, h, b0, b1)
    want = ((skip.float() + h.float()) + (b0.float() + b1.float())).to(dtype)
    assert torch.equal(got, want)
    assert torch.equal(_residual_add_plain(skip, h, b0, b1), want)

    if dtype == torch.bfloat16:
        stepwise = (skip + h) + b0 + b1
        assert not torch.equal(got, stepwise)


def test_none_biases_are_left_out():
    skip, h, (b0,) = _inputs((2, 4, 4, 16), torch.float32, 1)

    assert torch.equal(residual_add(skip, h, b0, None), residual_add(skip, h, b0))
    assert torch.equal(residual_add(skip, h, None, None), residual_add(skip, h))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("biases", [0, 1, 2])
def test_gradients_match_autograd(dtype, biases):
    dtype = DTYPES[dtype]
    skip, h, bs = _inputs((2, 5, 3, 24), dtype, biases, seed=11)
    leaves = [t.clone().requires_grad_() for t in (skip, h, *bs)]
    plain = [t.clone().requires_grad_() for t in (skip, h, *bs)]
    g = torch.randn(skip.shape, generator=torch.Generator().manual_seed(12)).to(dtype)

    residual_add(*leaves).backward(g)
    (plain[0].float() + plain[1].float() + sum(b.float() for b in plain[2:])).to(dtype).backward(g)

    for got, want in zip(leaves, plain):
        assert got.grad.dtype == want.grad.dtype == dtype
        if got.ndim == 1:  # a bias: the sum over all but the channels
            tol = 1e-5 if dtype == torch.float32 else 2e-2
            torch.testing.assert_close(got.grad.float(), want.grad.float(), rtol=tol, atol=tol)
        else:
            assert torch.equal(got.grad, want.grad)


def test_gradient_of_a_bias_alone():
    skip, h, (b0, b1) = _inputs((3, 4, 4, 8), torch.float32, 2, seed=5)
    b1 = b1.clone().requires_grad_()
    g = torch.randn(skip.shape, generator=torch.Generator().manual_seed(6))

    residual_add(skip, h, b0, b1).backward(g)
    torch.testing.assert_close(b1.grad, g.sum(dim=(0, 1, 2)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "shapes",
    [
        ((2, 4, 8), (2, 4, 4), ()),
        ((2, 4, 8), (2, 4, 8), ((4,),)),
        ((2, 4, 8), (2, 4, 8), ((1, 8),)),
        ((2, 4, 8), (2, 4, 8), ((8,), (8,), (8,))),
    ],
)
def test_refuses_mismatched_shapes(shapes):
    s, h, bs = shapes
    with pytest.raises(ValueError):
        residual_add(torch.zeros(s), torch.zeros(h), *(torch.zeros(b) for b in bs))


@pytest.mark.parametrize(
    "dtypes",
    [
        ("bfloat16", "bfloat16", "float32"),
        ("float32", "bfloat16", "bfloat16"),
        ("bfloat16", "float32", "float32"),
    ],
)
def test_mixed_dtypes_take_the_output_dtype(dtypes):
    # the output takes the promoted dtype of skip and h; the biases are taken
    # in it, rounded first where they are wider
    s_dtype, h_dtype, b_dtype = (DTYPES[d] for d in dtypes)
    skip, h, bs = _inputs((2, 4, 4, 16), torch.float32, 2, seed=9)
    skip, h, bs = skip.to(s_dtype), h.to(h_dtype), [b.to(b_dtype) for b in bs]
    dtype = torch.promote_types(s_dtype, h_dtype)

    got = residual_add(skip, h, *bs)
    want = ((skip.float() + h.float()) + (bs[0].to(dtype).float() + bs[1].to(dtype).float())).to(dtype)
    assert got.dtype == dtype
    assert torch.equal(got, want)


# on the card

ADM256 = dict(  # noqa: C408  guided-diffusion's 256x256 unconditional flags
    image_size=256,
    num_channels=256,
    num_res_blocks=2,
    channel_mult=(1, 1, 2, 2, 4, 4),
    attention_resolutions=(32, 16, 8),
    num_head_channels=64,
    resblock_updown=True,
    use_scale_shift_norm=True,
)


def _launches() -> int:
    return _build.LAUNCHES["residual_add"]


@pytest.mark.card
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("biases", [0, 1, 2])
@pytest.mark.parametrize(
    "shape", [(16, 256, 256, 256), (16, 8, 8, 1024), (3, 5, 7, 24), (2, 3, 3, 4096), (2, 3, 5, 42), (5, 3)]
)
def test_kernel_matches_plain(card, shape, biases, dtype):
    # the same float32 expression in the same order, rounded once: bit for
    # bit, in 16-byte vectors or (C = 42 in bf16, 3) one element at a time
    dtype = DTYPES[dtype]
    if dtype == torch.float32 and math.prod(shape) > 2**26:
        shape = (4, *shape[1:])  # float32 at a quarter of the batch: 1 GiB a tensor
    skip, h, bs = _inputs(shape, dtype, biases, seed=biases, device="cuda")

    before = _launches()
    got = residual_add(skip, h, *bs)
    torch.cuda.synchronize()
    assert _launches() == before + 1

    assert torch.equal(got, _residual_add_plain(skip, h, *bs))


@pytest.mark.card
def test_kernel_gradients(card):
    # the kernel's forward under autograd, and the gradient as it is to skip
    # and h and its channel sums to the biases
    skip, h, bs = _inputs((4, 16, 16, 256), torch.bfloat16, 2, seed=3, device="cuda")
    g = torch.randn(skip.shape, device="cuda", dtype=torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (skip, h, *bs)]

    before = _launches()
    y = residual_add(*leaves)
    assert _launches() == before + 1
    assert torch.equal(y.detach(), _residual_add_plain(skip, h, *bs))

    y.backward(g)
    assert torch.equal(leaves[0].grad, g) and torch.equal(leaves[1].grad, g)
    for b in leaves[2:]:
        assert torch.equal(b.grad, g.float().sum(dim=(0, 1, 2)).to(torch.bfloat16))


@pytest.mark.card
@pytest.mark.parametrize("case", ["transposed", "misaligned", "channels", "bias_dtype", "input_dtypes"])
def test_other_inputs_take_the_kernel(card, case):
    # strided inputs are made contiguous, other dtypes brought to the output
    # dtype; a misaligned pointer or a C that holds no whole 16-byte vectors
    # takes the kernel one element at a time
    skip, h, bs = _inputs((2, 8, 8, 64), torch.bfloat16, 2, device="cuda")
    if case == "transposed":
        skip, h = skip.transpose(1, 2), h.transpose(1, 2)
    elif case == "misaligned":
        flat = torch.empty(h.numel() + 1, device="cuda", dtype=h.dtype)
        h = flat[1:].view(h.shape).copy_(h)
    elif case == "channels":
        skip, h, bs = _inputs((2, 8, 8, 42), torch.bfloat16, 2, device="cuda")
    elif case == "bias_dtype":
        bs = [b.float() + 1e-3 for b in bs]
    else:
        skip = skip.float()

    before = _launches()
    got = residual_add(skip, h, *bs)
    assert _launches() == before + 1
    assert torch.equal(got, _residual_add_plain(skip, h, *bs))


@pytest.mark.card
def test_kernel_refuses_other_dtypes(card):
    skip, h, bs = _inputs((2, 4, 4, 16), torch.float16, 1, device="cuda")
    with pytest.raises(TypeError):
        residual_add(skip, h, *bs)


@pytest.mark.card
def test_adm256_forward_launches_one_a_resblock(card):
    # ADM-256 (guided-diffusion's 256x256 unconditional flags) at batch 1: 42
    # residual blocks, each ending in one launch
    from azula_tpu_torch.models import adm

    denoiser = adm.make_model(**ADM256, device="cuda", dtype=torch.bfloat16).eval()
    unet = denoiser.backbone
    resblocks = sum(isinstance(m, adm.backbone.ADMResBlock) for m in unet.modules())
    assert resblocks == 42

    x = torch.randn(1, 256, 256, 3, device="cuda", dtype=torch.bfloat16)
    with torch.inference_mode():
        before = _launches()
        unet(x, torch.full((1,), 500.0, device="cuda"))
        torch.cuda.synchronize()
    assert _launches() - before == 42

