"""TowerUNet (port of cultionet_tpu/models/tower_unet.py; conv temporal
front end only)."""

import typing as T

import torch
from torch import nn

from ..enums import AttentionTypes
from .temporal import PreTimeReduction
from .unet_parts import (
    TowerUNetDecoder,
    TowerUNetEncoder,
    TowerUNetFinal,
    TowerUNetFinalCombine,
    TowerUNetFusion,
)

Tensor = torch.Tensor


class TowerUNet(nn.Module):
    """UNet3+/Psi-Net-style encoder-decoder with ResUNet-a blocks and dilated
    neighborhood attention in the decoder, fed by the temporal-reduction
    front end; three per-pixel streams (distance, edge, crop).

    ``forward`` takes ``x`` as ``(B, T, H, W, C)`` and returns NCHW maps.
    """

    def __init__(
        self,
        in_channels: int,
        in_time: int,
        hidden_channels: int = 64,
        dilations: T.Optional[T.Sequence[int]] = None,
        activation_type: str = "SiLU",
        dropout: float = 0.0,
        attention_weights: T.Optional[str] = AttentionTypes.NATTEN,
    ):
        super().__init__()
        channels = [
            hidden_channels,
            hidden_channels * 2,
            hidden_channels * 4,
            hidden_channels * 8,
        ]
        up_channels = hidden_channels * 4
        self.pre_unet = PreTimeReduction(
            in_channels, channels[0], in_time, activation_type
        )
        self.encoder = TowerUNetEncoder(
            channels[0], channels, dilations, activation_type, dropout
        )
        self.decoder = TowerUNetDecoder(
            channels,
            up_channels,
            dilations,
            activation_type,
            dropout,
            attention_weights=attention_weights,
        )
        self.tower_fusion = TowerUNetFusion(
            channels, up_channels, dilations, activation_type
        )
        self.final_a = TowerUNetFinal(up_channels, activation_type)
        self.final_b = TowerUNetFinal(
            up_channels, activation_type, resample_factor=2
        )
        self.final_c = TowerUNetFinal(
            up_channels, activation_type, resample_factor=4
        )
        self.final_combine = TowerUNetFinalCombine()

    def forward(self, x: Tensor) -> T.Dict[str, Tensor]:
        embeddings = self.pre_unet(x)
        encoded = self.encoder(embeddings)
        decoded = self.decoder(encoded)
        towers = self.tower_fusion(encoded, decoded)
        size_a = towers["x_tower_a"].shape[-2:]
        out_a = self.final_a(towers["x_tower_a"], suffix="_a")
        out_b = self.final_b(towers["x_tower_b"], size=size_a, suffix="_b")
        out_c = self.final_c(towers["x_tower_c"], size=size_a, suffix="_c")
        return self.final_combine(out_a, out_b, out_c)
