"""CultioNet: the top-level model (port of cultionet_tpu/models/cultionet.py).

Every model option of the JAX CultioNet builds here: ``res_block_type``
('resa' or 'res'), ``attention_weights`` (natten, spatial_channel or
none; 'res' takes no natten, as the JAX block asserts), ``pool_by_max``,
``batchnorm_first``, ``use_latlon``, ``temporal_encoder`` and ``remat``.
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
        pool_by_max: bool = False,
        batchnorm_first: bool = False,
        use_latlon: bool = False,
        temporal_encoder: str = "conv",
        remat: bool = False,
    ):
        super().__init__()
        if model_type != ModelTypes.TOWERUNET:
            raise ValueError("The model type is not supported.")
        self.mask_model = TowerUNet(
            in_channels=in_channels,
            in_time=in_time,
            hidden_channels=hidden_channels,
            dilations=dilations,
            activation_type=activation_type,
            dropout=dropout,
            res_block_type=res_block_type,
            attention_weights=attention_weights,
            pool_by_max=pool_by_max,
            batchnorm_first=batchnorm_first,
            use_latlon=use_latlon,
            temporal_encoder=temporal_encoder,
            remat=remat,
        )

    def forward(
        self,
        x: Tensor,
        lat: T.Optional[Tensor] = None,
        lon: T.Optional[Tensor] = None,
    ) -> T.Dict[str, T.Optional[Tensor]]:
        """x: (B, T, H, W, C), as the JAX ``Batch.x``; ``lat`` and ``lon``:
        the chips' (B,) centroids in degrees, as ``Batch.lat`` and
        ``Batch.lon``, used by a ``use_latlon`` model only when both are
        given. They go in fp32 whatever the compute type, as the JAX step
        casts only ``x``. Returns the JAX package's output dict:
        channels-last (B, H, W, 1) maps plus the vestigial ``None``
        keys."""
        latlon_coords = None
        if lat is not None and lon is not None:
            latlon_coords = torch.stack([lon, lat], dim=-1).float()
        out = {
            name: value.permute(0, 2, 3, 1)
            for name, value in self.mask_model(x, latlon_coords).items()
        }
        out.update(
            {
                InferenceNames.CROP_TYPE: None,
                InferenceNames.CLASSES_L2: None,
                InferenceNames.CLASSES_L3: None,
            }
        )
        return out
