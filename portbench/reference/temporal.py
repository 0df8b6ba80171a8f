"""Temporal embedding front ends (port of
cultionet_tpu/models/temporal.py).

- ``PreTimeReduction`` (``temporal_encoder="conv"``): the JAX package packs
  (T, C) onto the TPU lanes and runs both time convs as matmuls; here they
  are ``nn.Conv3d``s with ``(kT, 1, 1)`` kernels (``TimeConv``), the same
  parameters and the same math.
- ``TemporalTransformer`` (``temporal_encoder="transformer"``): the math of
  the JAX module's unpacked path, on pixel-major tokens (B*H*W, T, D); its
  attention is ``temporal_attention.py``'s plain PyTorch version.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .activations import get_activation
from .blocks import BatchNorm, channels_first, channels_last
from .dropout import Dropout
from .init import LecunLinear
from .temporal_attention import temporal_attention

Tensor = torch.Tensor


class TimeConv(nn.Conv3d):
    """An ``nn.Conv3d`` with a ``(kT, 1, 1)`` kernel, computed as the 2-D
    convolution of (B, C, T, H*W) with the (O, C, kT, 1) kernel: the same
    parameters and the same sums. torch's CPU bf16 ``conv3d`` weight
    gradient (oneDNN) crashes or never returns for a 1x1 spatial kernel
    from about 99x99 pixels on (torch 2.13.0+cpu); the 2-D one does not."""

    def forward(self, x: Tensor) -> Tensor:
        b, c, t, h, w = x.shape
        y = F.conv2d(x.reshape(b, c, t, h * w), self.weight.squeeze(-1))
        return y.reshape(b, y.shape[1], y.shape[2], h, w)


class Conv3d(nn.Module):
    """Two stacked time-axis convolutions collapsing T -> 1.

    Input (B, C, T, H, W); output (B, out_channels, H, W).
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        in_time: int,
        kernel_size: int,
        activation_type: str = "SiLU",
    ):
        super().__init__()
        remaining_time = in_time - kernel_size + 1
        if remaining_time < 1:
            raise ValueError(
                f"in_time={in_time} too short for temporal kernel "
                f"{kernel_size}; need in_time >= {kernel_size}"
            )
        self.act = get_activation(activation_type)
        self.Conv_0 = TimeConv(
            in_channels, in_channels, (kernel_size, 1, 1), bias=False
        )
        self.BatchNorm_0 = BatchNorm(in_channels)
        self.Conv_1 = TimeConv(
            in_channels, out_channels, (remaining_time, 1, 1), bias=False
        )
        self.BatchNorm_1 = BatchNorm(out_channels)

    def forward(self, x: Tensor) -> Tensor:
        x = self.act(self.BatchNorm_0(self.Conv_0(x)))
        x = self.Conv_1(x).squeeze(2)
        return self.act(self.BatchNorm_1(x))


class PreTimeReduction(nn.Module):
    """Sum of the kT=3 and kT=5 temporal pyramids, then LayerNorm over
    channels. Input (B, T, H, W, C) as the JAX batch lays it out; output
    NCHW."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        in_time: int,
        activation_type: str = "SiLU",
    ):
        super().__init__()
        self.conv3 = Conv3d(
            in_channels, out_channels, in_time, 3, activation_type
        )
        self.conv5 = Conv3d(
            in_channels, out_channels, in_time, 5, activation_type
        )
        self.LayerNorm_0 = nn.LayerNorm(out_channels, eps=1e-5)

    def forward(self, x: Tensor) -> Tensor:
        x = x.permute(0, 4, 1, 2, 3)  # (B, C, T, H, W)
        x = self.conv3(x) + self.conv5(x)
        return channels_first(self.LayerNorm_0(channels_last(x)))


def sinusoid_encoding_table(positions: int, dim: int) -> np.ndarray:
    """UTAE-style sinusoid table (reference layers/encodings.py:25-35), the
    JAX package's numpy function, so the tables are identical."""
    table = np.array(
        [
            [p / np.power(10000, 2 * (i // 2) / dim) for i in range(dim)]
            for p in range(positions)
        ],
        dtype=np.float32,
    )
    table[:, 0::2] = np.sin(table[:, 0::2])
    table[:, 1::2] = np.cos(table[:, 1::2])
    return table


class TemporalTransformer(nn.Module):
    """Per-pixel temporal self-attention embedding: (B, T, H, W, C) as the
    JAX batch lays it out -> NCHW (B, out_channels, H, W).

    Tokens are each pixel's per-step channel vectors projected to
    ``d_model`` (``Dense_0``) plus the sinusoid table in the tokens' dtype;
    ``num_layers`` pre-LN blocks (LayerNorm, qkv ``Dense``, attention over
    T, projection, dropout on the projected output, residual; LayerNorm,
    MLP D -> 2D -> D with flax's default init, residual) run over T; a
    learned query (``pool_query``, through its LayerNorm and ``Dense``)
    pools T -> 1 against LayerNorm'd, projected keys and values; a last
    ``Dense`` and LayerNorm give the embedding. Submodules carry the flax
    names of the JAX module (``Dense_0`` ... ``Dense_{4L+4}``,
    ``LayerNorm_0`` ... ``LayerNorm_{2L+2}``, ``pool_query``).
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        in_time: int,
        d_model: int = 64,
        num_heads: int = 4,
        num_layers: int = 2,
        dropout: float = 0.0,
        activation_type: str = "SiLU",
    ):
        super().__init__()
        self.num_heads = num_heads
        self.num_layers = num_layers
        self.act = get_activation(activation_type)
        d = d_model

        def dense(i: int, fan_in: int, width: int, layer=nn.Linear):
            setattr(self, f"Dense_{i}", layer(fan_in, width))

        def norm(i: int) -> None:
            setattr(self, f"LayerNorm_{i}", nn.LayerNorm(d, eps=1e-5))

        dense(0, in_channels, d)
        for layer in range(num_layers):
            norm(2 * layer)
            dense(4 * layer + 1, d, 3 * d)
            dense(4 * layer + 2, d, d)
            norm(2 * layer + 1)
            dense(4 * layer + 3, d, 2 * d, LecunLinear)
            dense(4 * layer + 4, 2 * d, d, LecunLinear)
        top = 4 * num_layers
        norm(2 * num_layers)  # the pooling keys
        norm(2 * num_layers + 1)  # the pooling query
        dense(top + 1, d, d)  # query
        dense(top + 2, d, d)  # keys
        dense(top + 3, d, d)  # values
        dense(top + 4, d, out_channels)
        setattr(
            self,
            f"LayerNorm_{2 * num_layers + 2}",
            nn.LayerNorm(out_channels, eps=1e-5),
        )
        self.pool_query = nn.Parameter(torch.zeros(1, 1, 1, 1, d))
        self.normal_init = {"pool_query": 0.02}
        self.dropout = Dropout(dropout)
        self.in_time, self.d_model = in_time, d

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        batch, time, height, width, channels = x.shape

        def dense(i: int) -> nn.Module:
            return getattr(self, f"Dense_{i}")

        def norm(i: int) -> nn.Module:
            return getattr(self, f"LayerNorm_{i}")

        # Pixel-major tokens: one pixel's (T, C) rows are contiguous.
        x = x.permute(0, 2, 3, 1, 4).reshape(-1, time, channels)
        # The table in the tokens' dtype: an fp32 table would promote bf16
        # tokens to fp32.
        position_table = torch.from_numpy(
            sinusoid_encoding_table(self.in_time, self.d_model)
        ).to(device=x.device, dtype=x.dtype)
        tokens = dense(0)(x) + position_table

        for layer in range(self.num_layers):
            qkv = dense(4 * layer + 1)(norm(2 * layer)(tokens))
            q, k, v = qkv.chunk(3, dim=-1)
            attn = dense(4 * layer + 2)(
                temporal_attention(q, k, v, self.num_heads)
            )
            tokens = tokens + self.dropout(attn)
            mlp = self.act(dense(4 * layer + 3)(norm(2 * layer + 1)(tokens)))
            tokens = tokens + dense(4 * layer + 4)(mlp)

        # Learned-query pooling over T: the query is one vector for every
        # pixel, broadcast (stride 0) to (pixels, 1, D).
        top, nl = 4 * self.num_layers, self.num_layers
        query = dense(top + 1)(
            norm(2 * nl + 1)(self.pool_query.reshape(1, 1, -1))
        )
        keys = norm(2 * nl)(tokens)
        pooled = temporal_attention(
            query.expand(tokens.shape[0], 1, -1),
            dense(top + 2)(keys),
            dense(top + 3)(keys),
            self.num_heads,
        )
        out = norm(2 * nl + 2)(dense(top + 4)(pooled[:, 0]))
        return channels_first(out.reshape(batch, height, width, -1))
