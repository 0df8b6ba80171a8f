from .activations import get_activation
from .attention import NeighborhoodAttention2D
from .blocks import (
    BatchNorm,
    ConvBlock2d,
    ConvTranspose2d,
    PoolResidualConv,
    ResConvBlock2d,
    ResidualAConv,
)
from .resize import resize_bilinear_align_corners

__all__ = [
    "BatchNorm",
    "ConvBlock2d",
    "ConvTranspose2d",
    "NeighborhoodAttention2D",
    "PoolResidualConv",
    "ResConvBlock2d",
    "ResidualAConv",
    "get_activation",
    "resize_bilinear_align_corners",
]
