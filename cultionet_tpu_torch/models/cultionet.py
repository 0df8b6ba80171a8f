"""CultioNet: the top-level model (port of cultionet_tpu/models/cultionet.py).

Not yet ported (listed in ROADMAP.md): lat/lon GeoEmbeddings, ResidualConv
(``res_block_type='res'``), spatial-channel attention, pool-by-max and
batchnorm-first blocks.
"""

import typing as T

import torch
from torch import nn

from ..enums import AttentionTypes, InferenceNames, ModelTypes, ResBlockTypes
from .tower_unet import TowerUNet

Tensor = torch.Tensor


class CultioNet(nn.Module):
    def __init__(
        self,
        in_time: int,
        in_channels: int = 3,
        hidden_channels: int = 32,
        model_type: str = ModelTypes.TOWERUNET,
        activation_type: str = "SiLU",
        dropout: float = 0.1,
        dilations: T.Optional[T.Sequence[int]] = None,
        res_block_type: str = ResBlockTypes.RESA,
        attention_weights: T.Optional[str] = AttentionTypes.NATTEN,
        temporal_encoder: str = "conv",
    ):
        super().__init__()
        if model_type != ModelTypes.TOWERUNET:
            raise ValueError("The model type is not supported.")
        if res_block_type != ResBlockTypes.RESA:
            raise NotImplementedError(
                f"res_block_type {res_block_type!r} is not ported yet"
            )
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
        """x: (B, T, H, W, C), as the JAX ``Batch.x``. Returns the JAX
        package's output dict: channels-last (B, H, W, 1) maps plus the
        vestigial ``None`` keys."""
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
