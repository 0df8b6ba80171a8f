"""Convolutional building blocks (NCHW; port of cultionet_tpu/nn/blocks.py).

Submodules carry the flax scope names of the JAX modules (``Conv_0``,
``BatchNorm_0``, ``res_branch_0``, ``LayerNorm_0`` ...), so a flax variable
path joined with dots is the torch ``state_dict`` key
(``utils/params.py``). Only the unpacked paths are ported: the JAX packed
variants keep the same parameter names and the same per-channel math.
Convolutions promote an input whose type differs from their weights', as
flax's do (``layers.py``).
"""

import typing as T

import torch
import torch.nn.functional as F
from torch import nn

from ..enums import AttentionTypes, ResBlockTypes
from .activations import get_activation
from .attention import NeighborhoodAttention2D, SpatialChannelAttention
from .dropout import Dropout
from .layers import Conv2d, cast, promoted
from .layers import ConvTranspose2d as _ConvTranspose
from .remat import recomputing
from ..parallel.mesh import data_parallel_active, global_sum
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
    normalized per channel C like a 4-D one. An input whose type differs
    from the parameters' is normalized in the promoted type.

    Eval normalizes with the running statistics. Training normalizes with
    the batch statistics and updates the running ones as flax
    ``nn.BatchNorm(momentum=0.9)`` does: with the *biased* batch variance
    (torch's own update takes the unbiased one), the batch statistics in
    fp32, and the old running value rounded to the compute type (the
    parameters' type: the JAX step casts the statistics with the
    parameters) first, ``ra = bf16(0.9 * bf16(ra)) + 0.1 * stat`` under
    bf16 compute. The recompute of a rematerialized segment
    (``remat.py``) leaves the running statistics as they are.

    Inside ``parallel/mesh.py::data_parallel`` with more than one rank the
    batch statistics are the global batch's: the count, sum and sum of
    squares per channel (fp32) are summed over the data group, the
    variance is flax's ``E[x^2] - E[x]^2``, and the gradient flows back
    through the sums to every rank.
    """

    def __init__(self, channels: int):
        super().__init__()
        self.BatchNorm_0 = nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1)

    def forward(self, x: Tensor) -> Tensor:
        folded = x.dim() == 5
        x4 = x.flatten(2, 3) if folded else x
        bn = self.BatchNorm_0
        dtype = promoted(x, bn.weight)
        x4 = x4.to(dtype)
        weight, bias = cast(bn.weight, dtype), cast(bn.bias, dtype)
        if not self.training:
            out = F.batch_norm(
                x4,
                bn.running_mean.to(dtype),
                bn.running_var.to(dtype),
                weight,
                bias,
                training=False,
                eps=bn.eps,
            )
            return out.view(x.shape) if folded else out
        if data_parallel_active():
            return self._global_batch_norm(x, x4, weight, bias)
        if not recomputing():
            with torch.no_grad():
                var, mean = torch.var_mean(
                    x4.float(), dim=(0, 2, 3), correction=0
                )
                self._update_running(mean, var)
        out = F.batch_norm(
            x4, None, None, weight, bias, training=True, eps=bn.eps
        )
        # No view of a 4-D output: on the CPU a same-shape view between
        # batch_norm and a channels-last consumer (the front end's
        # LayerNorm) gave a wrong input gradient at batch 1.
        return out.view(x.shape) if folded else out

    @torch.no_grad()
    def _update_running(self, mean: Tensor, var: Tensor) -> None:
        bn = self.BatchNorm_0
        # 0.9 in the compute type: the product of two values of that type
        # is exact in fp32, so torch's fp32 arithmetic rounds it once, as
        # JAX's multiply in that type does.
        stats_dtype = bn.weight.dtype
        momentum = torch.tensor(0.9, dtype=stats_dtype).item()
        for running, stat in ((bn.running_mean, mean), (bn.running_var, var)):
            old = (running.to(stats_dtype) * momentum).float()
            running.copy_(old + 0.1 * stat)

    def _global_batch_norm(
        self, x: Tensor, x4: Tensor, weight: Tensor, bias: Tensor
    ) -> Tensor:
        bn = self.BatchNorm_0
        x32 = x4.float()
        count = torch.full(
            (1,), x32.numel() // x32.shape[1], dtype=torch.float32,
            device=x32.device,
        )
        sums = global_sum(
            torch.cat(
                [x32.sum(dim=(0, 2, 3)), (x32 * x32).sum(dim=(0, 2, 3)), count]
            )
        )
        channels = x32.shape[1]
        n = sums[-1]
        mean = sums[:channels] / n
        var = (sums[channels : 2 * channels] / n - mean * mean).clamp_min(0.0)
        if not recomputing():
            self._update_running(mean.detach(), var.detach())
        scale = torch.rsqrt(var + bn.eps)
        shape = (1, channels, 1, 1)
        out = (x32 - mean.view(shape)) * scale.view(shape)
        out = out * weight.float().view(shape) + bias.float().view(shape)
        out = out.to(x4.dtype)
        return out.view(x.shape) if x.dim() == 5 else out


class DepthwiseSeparableConv(nn.Module):
    """A depthwise conv (one group per input channel, same padding) then a
    1x1 conv, both with bias. The JAX package exports it; no model builds
    it."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int):
        super().__init__()
        self.Conv_0 = Conv2d(
            in_channels,
            out_channels,
            kernel_size,
            padding=kernel_size // 2,
            groups=in_channels,
        )
        self.Conv_1 = Conv2d(out_channels, out_channels, 1)

    def forward(self, x: Tensor) -> Tensor:
        return self.Conv_1(self.Conv_0(x))


class ConvTranspose2d(nn.Module):
    """Transposed conv (k=3, p=1; torch geometry: output
    ``(in-1)*stride + 1``) plus an align-corners bilinear fixup to the
    requested ``size``. The JAX module crops flax's VALID output to the
    same geometry, so the two agree for any stride."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 2):
        super().__init__()
        self.ConvTranspose_0 = _ConvTranspose(
            in_channels, out_channels, 3, stride=stride, padding=1
        )

    def forward(self, x: Tensor, size: T.Tuple[int, int]) -> Tensor:
        return resize_bilinear_align_corners(self.ConvTranspose_0(x), size)


class ConvBlock2d(nn.Module):
    """Conv (no bias) + BatchNorm + optional activation; with
    ``batchnorm_first``, BatchNorm over the *input* channels + activation
    + conv with bias (the activation is then always applied)."""

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
        batchnorm_first: bool = False,
    ):
        super().__init__()
        self.batchnorm_first = batchnorm_first
        self.Conv_0 = Conv2d(
            in_channels,
            out_channels,
            kernel_size,
            stride=stride,
            padding=padding,
            dilation=dilation,
            bias=batchnorm_first,
        )
        self.BatchNorm_0 = BatchNorm(
            in_channels if batchnorm_first else out_channels
        )
        self.act = (
            get_activation(activation_type)
            if add_activation or batchnorm_first
            else None
        )

    def forward(self, x: Tensor) -> Tensor:
        if self.batchnorm_first:
            return self.Conv_0(self.act(self.BatchNorm_0(x)))
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
        batchnorm_first: bool = False,
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
                    batchnorm_first=batchnorm_first,
                ),
            )

    def forward(self, x: Tensor) -> Tensor:
        for i in range(self.num_blocks):
            x = getattr(self, f"ConvBlock2d_{i}")(x)
        return x


def _skip(in_channels: int, out_channels: int) -> T.Optional[Conv2d]:
    """The 1x1 projection of a residual block's input, where the channel
    count changes."""
    if in_channels == out_channels:
        return None
    return Conv2d(in_channels, out_channels, 1)


class ResidualConv(nn.Module):
    """Residual conv with an optional CBAM gate (``--res-block-type res``):
    one conv branch summed onto the skip; with spatial-channel attention
    the sum is scaled by ``1 + gamma * attention`` (``gamma`` starts at
    1) and activated. The JAX block asserts that its attention is
    spatial-channel or none; here any other raises ``ValueError`` when
    the block is built."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        num_blocks: int = 2,
        attention_weights: T.Optional[str] = None,
        activation_type: str = "SiLU",
        batchnorm_first: bool = False,
    ):
        super().__init__()
        if attention_weights not in (None, AttentionTypes.SPATIAL_CHANNEL):
            raise ValueError(
                f"res_block_type 'res' takes attention_weights "
                f"'spatial_channel' or none, got {attention_weights!r}"
            )
        self.skip = _skip(in_channels, out_channels)
        self.ResConvBlock2d_0 = ResConvBlock2d(
            in_channels,
            out_channels,
            kernel_size=kernel_size,
            num_blocks=num_blocks,
            activation_type=activation_type,
            batchnorm_first=batchnorm_first,
        )
        self.gated = attention_weights is not None
        if self.gated:
            self.SpatialChannelAttention_0 = SpatialChannelAttention(
                out_channels, activation_type
            )
            self.gamma = nn.Parameter(torch.ones(1))
            self.act = get_activation(activation_type)

    def forward(self, x: Tensor) -> Tensor:
        out = x if self.skip is None else self.skip(x)
        out = out + self.ResConvBlock2d_0(x)
        if self.gated:
            attention = self.SpatialChannelAttention_0(out)
            out = self.act(out * (1.0 + self.gamma * attention))
        return out


class ResidualAConv(nn.Module):
    """ResUNet-a block: parallel dilated branches summed onto a 1x1 skip,
    with optional neighborhood attention in a LayerNorm sandwich (added) or
    a spatial-channel gate of the skip (multiplied)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        num_blocks: int = 2,
        dilations: T.Optional[T.Sequence[int]] = None,
        attention_weights: T.Optional[str] = None,
        activation_type: str = "SiLU",
        batchnorm_first: bool = False,
        natten_num_heads: int = 8,
        natten_kernel_size: int = 3,
        natten_dilation: int = 1,
        natten_attn_drop: float = 0.0,
        natten_proj_drop: float = 0.0,
    ):
        super().__init__()
        dilations = list(dilations) if dilations is not None else [1, 2]
        if attention_weights not in (
            None,
            AttentionTypes.NATTEN,
            AttentionTypes.SPATIAL_CHANNEL,
        ):
            raise ValueError(f"Unsupported attention type: {attention_weights}")
        self.skip = _skip(in_channels, out_channels)
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
                    batchnorm_first=batchnorm_first,
                ),
            )
        self.attention = attention_weights
        if attention_weights == AttentionTypes.NATTEN:
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
        elif attention_weights == AttentionTypes.SPATIAL_CHANNEL:
            self.SpatialChannelAttention_0 = SpatialChannelAttention(
                out_channels, activation_type
            )

    def forward(self, x: Tensor) -> Tensor:
        skip = x if self.skip is None else self.skip(x)
        out = skip
        for i in range(self.num_branches):
            out = out + getattr(self, f"res_branch_{i}")(x)
        if self.attention == AttentionTypes.NATTEN:
            # LayerNorm over channels: the sandwich runs channels-last.
            attention = self.LayerNorm_0(channels_last(skip))
            attention = self.NeighborhoodAttention2D_0(attention)
            attention = self.LayerNorm_1(attention)
            out = out + channels_first(attention)
        elif self.attention == AttentionTypes.SPATIAL_CHANNEL:
            out = out * self.SpatialChannelAttention_0(skip)
        return out


def adaptive_max_pool_half(x: Tensor) -> Tensor:
    """``F.adaptive_max_pool2d(x, (H // 2, W // 2))`` as a fixed pool: for
    an output of n // 2 its windows are exactly a kernel-2 stride-2 pool
    for an even side n and a kernel-3 stride-2 pool for an odd one (the
    JAX package's ``reduce_window``)."""
    h, w = x.shape[-2:]
    return F.max_pool2d(
        x, (2 if h % 2 == 0 else 3, 2 if w % 2 == 0 else 3), stride=2
    )


class PoolResidualConv(nn.Module):
    """Downsample + residual block + channel dropout, without attention
    (the model builds its encoder without it). The downsampling is the
    adaptive max pool (``pool_by_max``), else under ``batchnorm_first`` a
    plain biased stride-2 conv ``pool_conv``, else a stride-2
    ``ConvBlock2d`` without activation; the block is a ``ResidualConv``
    (``res_block_type='res'``) or a ``ResidualAConv``."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        dropout: float = 0.0,
        kernel_size: int = 3,
        num_blocks: int = 2,
        activation_type: str = "SiLU",
        res_block_type: str = ResBlockTypes.RESA,
        dilations: T.Optional[T.Sequence[int]] = None,
        pool_first: bool = True,
        pool_by_max: bool = False,
        batchnorm_first: bool = False,
    ):
        super().__init__()
        if res_block_type not in (ResBlockTypes.RES, ResBlockTypes.RESA):
            raise ValueError(f"Unsupported res_block_type: {res_block_type}")
        self.pool_first = pool_first
        self.pool_by_max = pool_by_max
        if pool_first and not pool_by_max:
            if batchnorm_first:
                self.pool_conv = Conv2d(
                    in_channels, out_channels, 3, stride=2, padding=1
                )
            else:
                self.pool_conv = ConvBlock2d(
                    in_channels,
                    out_channels,
                    kernel_size=3,
                    padding=1,
                    stride=2,
                    add_activation=False,
                )
            in_channels = out_channels
        common = dict(
            kernel_size=kernel_size,
            num_blocks=num_blocks,
            activation_type=activation_type,
            batchnorm_first=batchnorm_first,
        )
        if res_block_type == ResBlockTypes.RES:
            self.block = "ResidualConv_0"
            block = ResidualConv(in_channels, out_channels, **common)
        else:
            self.block = "ResidualAConv_0"
            block = ResidualAConv(
                in_channels, out_channels, dilations=dilations, **common
            )
        self.add_module(self.block, block)
        self.dropout = Dropout(dropout, broadcast_dims=(2, 3))

    def forward(self, x: Tensor) -> Tensor:
        if self.pool_first:
            x = (
                adaptive_max_pool_half(x)
                if self.pool_by_max
                else self.pool_conv(x)
            )
        return self.dropout(getattr(self, self.block)(x))
