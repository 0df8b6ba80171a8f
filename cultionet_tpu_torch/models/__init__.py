from .cultionet import CultioNet
from .temporal import PreTimeReduction, TemporalTransformer
from .tower_unet import TowerUNet

__all__ = ["CultioNet", "PreTimeReduction", "TemporalTransformer", "TowerUNet"]
