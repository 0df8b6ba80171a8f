"""Augmentation of training chips (port of cultionet_tpu/augment/): the
host augmenters, and the in-step dihedral and noise augmentation on the
device (``device.py``)."""

from . import functional
from .augmenters import (
    AUGMENTATION_NAMES,
    SPATIAL_NAMES,
    TEMPORAL_NAMES,
    Augmenters,
    label_segments,
)
from .device import augment_batch_on_device

__all__ = [
    "AUGMENTATION_NAMES",
    "SPATIAL_NAMES",
    "TEMPORAL_NAMES",
    "Augmenters",
    "augment_batch_on_device",
    "functional",
    "label_segments",
]
