"""Temporal embedding front end (port of
cultionet_tpu/models/temporal.py::Conv3d / PreTimeReduction).

The JAX package packs (T, C) onto the TPU lanes and runs both time convs as
matmuls; here they are plain ``nn.Conv3d``s with ``(kT, 1, 1)`` kernels,
the same parameters and the same math.
"""

import torch
from torch import nn

from ..nn.activations import get_activation
from ..nn.blocks import BatchNorm, channels_first, channels_last

Tensor = torch.Tensor


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
        self.Conv_0 = nn.Conv3d(
            in_channels, in_channels, (kernel_size, 1, 1), bias=False
        )
        self.BatchNorm_0 = BatchNorm(in_channels)
        self.Conv_1 = nn.Conv3d(
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
