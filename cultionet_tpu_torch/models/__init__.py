from .cultionet import CultioNet
from .temporal import PreTimeReduction
from .tower_unet import TowerUNet

__all__ = ["CultioNet", "PreTimeReduction", "TowerUNet"]
