"""CultioNet: the top-level model, with the options the configurations
set (``hidden_channels``, ``dropout``, ``dilations``, ``activation_type``,
``attention_weights`` natten or none, ``temporal_encoder`` conv or
transformer); every other option at the CLI default.
"""

import typing as T

import torch
from torch import nn

from .enums import AttentionTypes, InferenceNames
from .tower_unet import TowerUNet

Tensor = torch.Tensor


class CultioNet(nn.Module):
    def __init__(
        self,
        in_time: int,
        in_channels: int = 3,
        hidden_channels: int = 32,
        activation_type: str = "SiLU",
        dropout: float = 0.1,
        dilations: T.Optional[T.Sequence[int]] = None,
        attention_weights: T.Optional[str] = AttentionTypes.NATTEN,
        temporal_encoder: str = "conv",
    ):
        super().__init__()
        self.mask_model = TowerUNet(
            in_channels=in_channels,
            in_time=in_time,
            hidden_channels=hidden_channels,
            dilations=dilations,
            activation_type=activation_type,
            dropout=dropout,
            attention_weights=attention_weights,
            temporal_encoder=temporal_encoder,
        )

    def forward(self, x: Tensor) -> T.Dict[str, T.Optional[Tensor]]:
        """x: (B, T, H, W, C). Returns the program's output dict:
        channels-last (B, H, W, 1) maps plus the vestigial ``None`` keys."""
        out = {
            name: value.permute(0, 2, 3, 1)
            for name, value in self.mask_model(x).items()
        }
        out.update(
            {
                InferenceNames.CROP_TYPE: None,
                InferenceNames.CLASSES_L2: None,
                InferenceNames.CLASSES_L3: None,
            }
        )
        return out
