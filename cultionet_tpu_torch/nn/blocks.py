"""Convolutional building blocks (NCHW; port of cultionet_tpu/nn/blocks.py).

Submodules carry the flax scope names of the JAX modules (``Conv_0``,
``BatchNorm_0``, ``res_branch_0``, ``LayerNorm_0`` ...), so a flax variable
path joined with dots is the torch ``state_dict`` key
(``utils/params.py``). Only the unpacked paths are ported: the JAX packed
variants keep the same parameter names and the same per-channel math.
"""

import typing as T

import torch
import torch.nn.functional as F
from torch import nn

from ..enums import AttentionTypes
from .activations import get_activation
from .attention import NeighborhoodAttention2D
from .dropout import Dropout
from .resize import resize_bilinear_align_corners

Tensor = torch.Tensor


def channels_last(x: Tensor) -> Tensor:
    return x.permute(0, 2, 3, 1)


def channels_first(x: Tensor) -> Tensor:
    return x.permute(0, 3, 1, 2)


class BatchNorm(nn.Module):
    """BatchNorm (eps 1e-5), nested as the flax wrapper is
    (``BatchNorm_0/BatchNorm_0``; the inner ``nn.BatchNorm2d`` holds the
    parameters and running statistics). A 5-D (B, C, T, H, W) input is
    normalized per channel C like a 4-D one.

    Eval normalizes with the running statistics. Training normalizes with
    the batch statistics and updates the running ones as flax
    ``nn.BatchNorm(momentum=0.9)`` does: with the *biased* batch variance
    (torch's own update takes the unbiased one), the batch statistics in
    fp32, and the old running value rounded to the input's type first,
    ``ra = bf16(0.9 * bf16(ra)) + 0.1 * stat`` under bf16 compute, as the
    JAX step's cast of the statistics to the compute type makes it.
    """

    def __init__(self, channels: int):
        super().__init__()
        self.BatchNorm_0 = nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1)

    def forward(self, x: Tensor) -> Tensor:
        x4 = x.flatten(2, 3) if x.dim() == 5 else x
        bn = self.BatchNorm_0
        if not self.training:
            return bn(x4).view_as(x)
        with torch.no_grad():
            var, mean = torch.var_mean(
                x4.float(), dim=(0, 2, 3), correction=0
            )
            # 0.9 in the input's type: the product of two values of that
            # type is exact in fp32, so torch's fp32 arithmetic rounds it
            # once, as JAX's multiply in that type does.
            momentum = torch.tensor(0.9, dtype=x.dtype).item()
            for running, stat in (
                (bn.running_mean, mean),
                (bn.running_var, var),
            ):
                old = (running.to(x.dtype) * momentum).float()
                running.copy_(old + 0.1 * stat)
        out = F.batch_norm(
            x4, None, None, bn.weight, bn.bias, training=True, eps=bn.eps
        )
        return out.view_as(x)


class ConvTranspose2d(nn.Module):
    """Transposed conv (k=3, p=1; torch geometry: output
    ``(in-1)*stride + 1``) plus an align-corners bilinear fixup to the
    requested ``size``. The JAX module crops flax's VALID output to the
    same geometry, so the two agree for any stride."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 2):
        super().__init__()
        self.ConvTranspose_0 = nn.ConvTranspose2d(
            in_channels, out_channels, 3, stride=stride, padding=1
        )

    def forward(self, x: Tensor, size: T.Tuple[int, int]) -> Tensor:
        return resize_bilinear_align_corners(self.ConvTranspose_0(x), size)


class ConvBlock2d(nn.Module):
    """Conv (no bias) + BatchNorm + optional activation."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int,
        padding: int = 0,
        dilation: int = 1,
        stride: int = 1,
        add_activation: bool = True,
        activation_type: str = "SiLU",
    ):
        super().__init__()
        self.Conv_0 = nn.Conv2d(
            in_channels,
            out_channels,
            kernel_size,
            stride=stride,
            padding=padding,
            dilation=dilation,
            bias=False,
        )
        self.BatchNorm_0 = BatchNorm(out_channels)
        self.act = get_activation(activation_type) if add_activation else None

    def forward(self, x: Tensor) -> Tensor:
        x = self.BatchNorm_0(self.Conv_0(x))
        return x if self.act is None else self.act(x)


class ResConvBlock2d(nn.Module):
    """Stacked conv blocks of a residual branch. The first block uses
    dilation 1 and same padding; later blocks use dilation
    ``max(1, dilation - 1)`` (the reference's rule)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        dilation: int = 1,
        activation_type: str = "SiLU",
        num_blocks: int = 2,
    ):
        super().__init__()
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        self.num_blocks = num_blocks
        later = 1 if kernel_size == 1 else max(1, dilation - 1)
        for i in range(num_blocks):
            first = i == 0
            self.add_module(
                f"ConvBlock2d_{i}",
                ConvBlock2d(
                    in_channels if first else out_channels,
                    out_channels,
                    kernel_size,
                    padding=0
                    if kernel_size == 1
                    else (kernel_size // 2 if first else later),
                    dilation=1 if first else later,
                    activation_type=activation_type,
                ),
            )

    def forward(self, x: Tensor) -> Tensor:
        for i in range(self.num_blocks):
            x = getattr(self, f"ConvBlock2d_{i}")(x)
        return x


class ResidualAConv(nn.Module):
    """ResUNet-a block: parallel dilated branches summed onto a 1x1 skip,
    with optional neighborhood attention in a LayerNorm sandwich."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        num_blocks: int = 2,
        dilations: T.Optional[T.Sequence[int]] = None,
        attention_weights: T.Optional[str] = None,
        activation_type: str = "SiLU",
        natten_num_heads: int = 8,
        natten_kernel_size: int = 3,
        natten_dilation: int = 1,
        natten_attn_drop: float = 0.0,
        natten_proj_drop: float = 0.0,
    ):
        super().__init__()
        dilations = list(dilations) if dilations is not None else [1, 2]
        if attention_weights not in (None, AttentionTypes.NATTEN):
            raise NotImplementedError(
                f"attention {attention_weights!r} is not ported yet"
            )
        self.skip = (
            nn.Conv2d(in_channels, out_channels, 1)
            if in_channels != out_channels
            else None
        )
        self.num_branches = len(dilations)
        for i, dilation in enumerate(dilations):
            self.add_module(
                f"res_branch_{i}",
                ResConvBlock2d(
                    in_channels,
                    out_channels,
                    kernel_size=kernel_size,
                    dilation=dilation,
                    activation_type=activation_type,
                    num_blocks=num_blocks,
                ),
            )
        self.natten = attention_weights == AttentionTypes.NATTEN
        if self.natten:
            self.LayerNorm_0 = nn.LayerNorm(out_channels, eps=1e-5)
            self.NeighborhoodAttention2D_0 = NeighborhoodAttention2D(
                out_channels,
                num_heads=natten_num_heads,
                kernel_size=natten_kernel_size,
                dilation=natten_dilation,
                attn_drop=natten_attn_drop,
                proj_drop=natten_proj_drop,
            )
            self.LayerNorm_1 = nn.LayerNorm(out_channels, eps=1e-5)

    def forward(self, x: Tensor) -> Tensor:
        skip = x if self.skip is None else self.skip(x)
        out = skip
        for i in range(self.num_branches):
            out = out + getattr(self, f"res_branch_{i}")(x)
        if self.natten:
            # LayerNorm over channels: the sandwich runs channels-last.
            attention = self.LayerNorm_0(channels_last(skip))
            attention = self.NeighborhoodAttention2D_0(attention)
            attention = self.LayerNorm_1(attention)
            out = out + channels_first(attention)
        return out


class PoolResidualConv(nn.Module):
    """Strided-conv downsample + residual block + channel dropout.
    Only the default downsampling (ConvBlock2d, stride 2, no activation) is
    ported, without attention: the model builds its encoder without it."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        dropout: float = 0.0,
        kernel_size: int = 3,
        num_blocks: int = 2,
        activation_type: str = "SiLU",
        dilations: T.Optional[T.Sequence[int]] = None,
        pool_first: bool = True,
    ):
        super().__init__()
        self.pool_conv = None
        if pool_first:
            self.pool_conv = ConvBlock2d(
                in_channels,
                out_channels,
                kernel_size=3,
                padding=1,
                stride=2,
                add_activation=False,
            )
            in_channels = out_channels
        self.ResidualAConv_0 = ResidualAConv(
            in_channels,
            out_channels,
            kernel_size=kernel_size,
            num_blocks=num_blocks,
            dilations=dilations,
            activation_type=activation_type,
        )
        self.dropout = Dropout(dropout, broadcast_dims=(2, 3))

    def forward(self, x: Tensor) -> Tensor:
        if self.pool_conv is not None:
            x = self.pool_conv(x)
        return self.dropout(self.ResidualAConv_0(x))
