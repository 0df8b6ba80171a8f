"""The string enums the reference model and its step use."""

import enum


class StrEnum(str, enum.Enum):
    """String enum whose members compare equal to their value."""

    def __str__(self) -> str:
        return self.value


class AttentionTypes(StrEnum):
    NATTEN = "natten"


class InferenceNames(StrEnum):
    CLASSES_L2 = "classes_l2"
    CLASSES_L3 = "classes_l3"
    CROP_TYPE = "crop_type"
    DISTANCE = "distance"
    EDGE = "edge"
    CROP = "crop"
    RECONSTRUCTION = "reconstruction"


class ValidationNames(StrEnum):
    TRUE_CROP = "true_crop"
    TRUE_EDGE = "true_edge"
    TRUE_CROP_AND_EDGE = "true_crop_and_edge"
    TRUE_CROP_OR_EDGE = "true_crop_or_edge"
    TRUE_CROP_TYPE = "true_crop_type"
    MASK = "mask"
