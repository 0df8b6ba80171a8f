"""Attention modules (port of cultionet_tpu/nn/attention.py): the
CBAM-style spatial-channel gate (NCHW) and neighborhood attention
(channels-last)."""

import torch
from torch import nn

from ..ops.natten import na2d
from .activations import get_activation
from .dropout import Dropout, dropout_generator
from .layers import Conv2d

Tensor = torch.Tensor


class ChannelAttention(nn.Module):
    """Channel gates from the global average and max pools, each through
    its own two 1x1 convs without bias (C -> C/2 -> C), summed, sigmoid;
    (B, C, 1, 1), broadcast over the map by its user."""

    def __init__(self, channels: int, activation_type: str = "SiLU"):
        super().__init__()
        for pool in ("avg", "max"):
            self.add_module(
                f"{pool}_fc1", Conv2d(channels, channels // 2, 1, bias=False)
            )
            self.add_module(
                f"{pool}_fc2", Conv2d(channels // 2, channels, 1, bias=False)
            )
        self.act = get_activation(activation_type)

    def _mlp(self, pool: str, z: Tensor) -> Tensor:
        z = self.act(getattr(self, f"{pool}_fc1")(z))
        return getattr(self, f"{pool}_fc2")(z)

    def forward(self, x: Tensor) -> Tensor:
        avg = x.mean(dim=(2, 3), keepdim=True)
        peak = x.amax(dim=(2, 3), keepdim=True)
        return torch.sigmoid(self._mlp("avg", avg) + self._mlp("max", peak))


class SpatialAttention(nn.Module):
    """A spatial gate: the channel mean and max through a 2 -> 1 3x3 conv
    without bias, sigmoid; (B, 1, H, W)."""

    def __init__(self):
        super().__init__()
        self.Conv_0 = Conv2d(2, 1, 3, padding=1, bias=False)

    def forward(self, x: Tensor) -> Tensor:
        pooled = torch.cat(
            [x.mean(dim=1, keepdim=True), x.amax(dim=1, keepdim=True)], dim=1
        )
        return torch.sigmoid(self.Conv_0(pooled))


class SpatialChannelAttention(nn.Module):
    """The CBAM-style gate ``1 + gamma * (channel + spatial) / 2``, with
    ``gamma`` starting at 0 (the gate starts as the identity)."""

    def __init__(self, channels: int, activation_type: str = "SiLU"):
        super().__init__()
        self.ChannelAttention_0 = ChannelAttention(channels, activation_type)
        self.SpatialAttention_0 = SpatialAttention()
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: Tensor) -> Tensor:
        attention = (
            self.ChannelAttention_0(x) + self.SpatialAttention_0(x)
        ) * 0.5
        return 1.0 + self.gamma * attention


class NeighborhoodAttention2D(nn.Module):
    """Multi-head dilated neighborhood attention with a fused QKV projection.

    Mirrors natten.NeighborhoodAttention2D(dim, num_heads, kernel_size,
    dilation, rel_pos_bias=False, qkv_bias=True). Input and output are
    channels-last ``(B, H, W, C)``, the layout the qkv projection produces,
    so q, k and v reach the attention op as strided ``(B, H, W, N, D)``
    views of one tensor.
    """

    def __init__(
        self,
        channels: int,
        num_heads: int,
        kernel_size: int,
        dilation: int = 1,
        attn_drop: float = 0.0,
        proj_drop: float = 0.0,
    ):
        super().__init__()
        if channels % num_heads:
            raise ValueError(
                f"dim {channels} not divisible by heads {num_heads}"
            )
        self.num_heads = num_heads
        self.kernel_size = kernel_size
        self.dilation = dilation
        self.attn_drop = attn_drop
        self.qkv = nn.Linear(channels, channels * 3)
        self.proj = nn.Linear(channels, channels)
        self.proj_drop = Dropout(proj_drop)

    def forward(self, x: Tensor) -> Tensor:
        heads = self.num_heads
        # Thirds of the fused projection, then heads (torch reshapes the
        # fused projection as (3, heads, dim): the same column order).
        q, k, v = (
            t.unflatten(-1, (heads, -1)) for t in self.qkv(x).chunk(3, -1)
        )
        if self.training and self.attn_drop > 0:
            # Dropout on the attention weights, inside the kernels: the
            # seed is drawn from the step's generator (as the JAX module
            # draws it from the dropout rng) and stays on its device.
            generator = dropout_generator()
            seed = torch.randint(
                0,
                torch.iinfo(torch.int32).max,
                (1,),
                generator=generator,
                device=generator.device,
                dtype=torch.int32,
            ).to(q.device)
            out = na2d(
                q, k, v, self.kernel_size, self.dilation,
                attn_drop=self.attn_drop, seed=seed,
            )
        else:
            out = na2d(q, k, v, self.kernel_size, self.dilation)
        return self.proj_drop(self.proj(out.flatten(-2)))
