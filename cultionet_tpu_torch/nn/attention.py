"""Neighborhood attention module (port of
cultionet_tpu/nn/attention.py::NeighborhoodAttention2D)."""

import torch
from torch import nn

from ..ops.natten import na2d
from .dropout import Dropout, dropout_generator

Tensor = torch.Tensor


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
