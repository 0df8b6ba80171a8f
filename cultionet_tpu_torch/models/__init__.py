from .cultionet import CultioNet, create_model
from .temporal import PreTimeReduction, TemporalTransformer
from .tower_unet import TowerUNet
from .tsvit import TSViT
from .utae import UTAE

__all__ = [
    "CultioNet", "PreTimeReduction", "TemporalTransformer", "TowerUNet", "TSViT", "UTAE",
    "create_model",
]
