from .activations import get_activation
from .attention import (
    ChannelAttention,
    NeighborhoodAttention2D,
    SpatialAttention,
    SpatialChannelAttention,
)
from .blocks import (
    BatchNorm,
    ConvBlock2d,
    ConvTranspose2d,
    DepthwiseSeparableConv,
    PoolResidualConv,
    ResConvBlock2d,
    ResidualAConv,
    ResidualConv,
    adaptive_max_pool_half,
)
from .resize import resize_bilinear_align_corners

__all__ = [
    "BatchNorm",
    "ChannelAttention",
    "ConvBlock2d",
    "ConvTranspose2d",
    "DepthwiseSeparableConv",
    "NeighborhoodAttention2D",
    "PoolResidualConv",
    "ResConvBlock2d",
    "ResidualAConv",
    "ResidualConv",
    "SpatialAttention",
    "SpatialChannelAttention",
    "adaptive_max_pool_half",
    "get_activation",
    "resize_bilinear_align_corners",
]
