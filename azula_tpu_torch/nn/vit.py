r"""Vision Transformer (ViT) building blocks.

Port of :mod:`azula_tpu.nn.vit`: patchify to tokens, cartesian-product
integer coordinates as positions, unpatchify, in channels-last layout.

References:
    | An Image is Worth 16x16 Words (Dosovitskiy et al., 2021)
    | https://arxiv.org/abs/2010.11929
"""

from __future__ import annotations

__all__ = [
    "ViT",
]

import math
import torch

from collections.abc import Sequence
from torch import Tensor

from .dit import DiT
from .layers import Patchify, Unpatchify


class ViT(DiT):
    r"""Creates a modulated ViT-like module.

    Arguments:
        in_channels: The number of input channels :math:`C_i`.
        out_channels: The number of output channels :math:`C_o`.
        cond_channels: The number of condition channels :math:`C_c`.
        mod_features: The number of modulating features :math:`D`.
        hid_channels: The number of hidden token channels.
        hid_blocks: The number of hidden transformer blocks.
        spatial: The number of spatial dimensions :math:`N`.
        patch_size: The patch size or shape.
        unpatch_size: The unpatch size or shape.
        device: The device of the parameters. Defaults to the card (`'cuda'`).
        dtype: The dtype of the parameters. Defaults to float32.
        generator: The generator of the initial parameters (the JAX `key`).
        kwargs: Keyword arguments passed to :class:`~azula_tpu_torch.nn.dit.DiTBlock`.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        cond_channels: int = 0,
        mod_features: int = 0,
        hid_channels: int = 1024,
        hid_blocks: int = 3,
        spatial: int = 2,
        patch_size: int | Sequence[int] = 1,
        unpatch_size: int | Sequence[int] | None = None,
        *,
        device=None,
        dtype=None,
        generator: torch.Generator | None = None,
        **kwargs,
    ) -> None:
        if isinstance(patch_size, int):
            patch_size = [patch_size] * spatial

        if unpatch_size is None:
            unpatch_size = patch_size
        elif isinstance(unpatch_size, int):
            unpatch_size = [unpatch_size] * spatial

        if not len(patch_size) == len(unpatch_size) == spatial:
            raise ValueError(f"patch and unpatch shapes must have {spatial} entries")

        super().__init__(
            in_channels=math.prod(patch_size) * in_channels,
            out_channels=math.prod(unpatch_size) * out_channels,
            cond_channels=math.prod(patch_size) * cond_channels,
            mod_features=mod_features,
            pos_channels=spatial,
            hid_channels=hid_channels,
            hid_blocks=hid_blocks,
            device=device,
            dtype=dtype,
            generator=generator,
            **kwargs,
        )

        self.patch = Patchify(patch_size)
        self.unpatch = Unpatchify(unpatch_size)
        self.spatial = spatial

    def forward(
        self,
        x: Tensor,
        mod: Tensor | None = None,
        cond: Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> Tensor:
        r"""
        Arguments:
            x: The input tensor, with shape :math:`(B, L_1, ..., L_N, C_i)`.
            mod: The modulation vector, with shape :math:`(D)` or :math:`(B, D)`.
            cond: The condition tensor, with shape :math:`(B, L_1, ..., L_N, C_c)`.
            generator: The generator of the dropout, which it enables
                (training; the JAX `key`).

        Returns:
            The output tensor, with shape :math:`(B, L_1, ..., L_N, C_o)`.
        """

        x = self.patch(x)

        if cond is not None:
            cond = self.patch(cond)

        shape = x.shape[1:-1]

        # cartesian-product integer coordinates, in the activations' dtype
        grids = torch.meshgrid(
            *(torch.arange(size, device=x.device).to(x.dtype) for size in shape), indexing="ij"
        )
        pos = torch.stack(grids, dim=-1).reshape(-1, len(shape))

        x = x.flatten(1, -2)
        if cond is not None:
            cond = cond.flatten(1, -2)

        y = DiT.forward(self, x, mod, pos=pos, cond=cond, generator=generator)
        y = y.reshape(y.shape[0], *shape, y.shape[-1])

        return self.unpatch(y)
