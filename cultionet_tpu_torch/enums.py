"""String-enum registries (copy of the names the ported path needs from
cultionet_tpu/enums.py)."""

import enum


class StrEnum(str, enum.Enum):
    """String enum whose members compare equal to their value."""

    def __str__(self) -> str:
        return self.value


class AttentionTypes(StrEnum):
    NATTEN = "natten"
    SPATIAL_CHANNEL = "spatial_channel"


class InferenceNames(StrEnum):
    CLASSES_L2 = "classes_l2"
    CLASSES_L3 = "classes_l3"
    CROP_TYPE = "crop_type"
    DISTANCE = "distance"
    EDGE = "edge"
    CROP = "crop"
    RECONSTRUCTION = "reconstruction"


class ModelTypes(StrEnum):
    TOWERUNET = "TowerUNet"


class ResBlockTypes(StrEnum):
    RES = "res"
    RESA = "resa"
