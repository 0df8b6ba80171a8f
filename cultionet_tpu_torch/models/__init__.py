from .cultionet import CultioNet, create_model
from .temporal import PreTimeReduction, TemporalTransformer
from .tower_unet import TowerUNet
from .utae import UTAE

__all__ = [
    "CultioNet", "PreTimeReduction", "TemporalTransformer", "TowerUNet", "UTAE",
    "create_model",
]
