"""Host augmentation of training chips (port of cultionet_tpu/augment/,
without ``device.py``'s in-step augmentation)."""

from . import functional
from .augmenters import (
    AUGMENTATION_NAMES,
    SPATIAL_NAMES,
    TEMPORAL_NAMES,
    Augmenters,
    label_segments,
)

__all__ = [
    "AUGMENTATION_NAMES",
    "SPATIAL_NAMES",
    "TEMPORAL_NAMES",
    "Augmenters",
    "functional",
    "label_segments",
]
