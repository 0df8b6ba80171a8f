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


class CLISteps(StrEnum):
    CREATE = "create"
    CREATE_PREDICT = "create-predict"
    SKFOLDCV = "skfoldcv"
    TRAIN = "train"
    TRAIN_TRANSFER = "train-transfer"
    PREDICT = "predict"
    PREDICT_TRANSFER = "predict-transfer"
    IMPORT_TORCH = "import-torch"
    EXPORT = "export"
    VERSION = "version"


class Destinations(StrEnum):
    CKPT = "ckpt"
    DATA = "data"
    FIGURES = "figures"
    PREDICT = "predict"
    PROCESSED = "processed"
    TRAIN = "train"
    TEST = "test"
    TIME_SERIES_VARS = "time_series_vars"
    USER_TRAIN = "user_train"


class InferenceNames(StrEnum):
    CLASSES_L2 = "classes_l2"
    CLASSES_L3 = "classes_l3"
    CROP_TYPE = "crop_type"
    DISTANCE = "distance"
    EDGE = "edge"
    CROP = "crop"
    RECONSTRUCTION = "reconstruction"


class LossTypes(StrEnum):
    BOUNDARY = "BoundaryLoss"
    CROSS_ENTROPY = "CrossEntropyLoss"
    CENTERLINE_DICE = "CLDiceLoss"
    CLASS_BALANCED_MSE = "ClassBalancedMSELoss"
    LOG_COSH = "LogCoshLoss"
    MASKED_CROSS_ENTROPY = "MaskedCrossEntropyLoss"
    FOCAL_TVERSKY = "FocalTverskyLoss"
    TANIMOTO_COMPLEMENT = "TanimotoComplementLoss"
    TANIMOTO = "TanimotoDistLoss"
    TANIMOTO_COMBINED = "TanimotoCombined"
    TVERSKY = "TverskyLoss"


class ModelNames(StrEnum):
    CLASS_INFO = "classes.info"
    CKPT_NAME = "last.ckpt"
    CKPT_TRANSFER_NAME = "last_transfer.ckpt"
    NORM = "last.norm"


class ModelTypes(StrEnum):
    TOWERUNET = "TowerUNet"
    UTAE = "UTAE"
    TSVIT = "TSViT"


class ResBlockTypes(StrEnum):
    RES = "res"
    RESA = "resa"


class LearningRateSchedulers(StrEnum):
    CONSTANT = "Constant"
    COSINE_ANNEALING_LR = "CosineAnnealingLR"
    EXPONENTIAL_LR = "ExponentialLR"
    ONE_CYCLE_LR = "OneCycleLR"
    STEP_LR = "StepLR"


class ValidationNames(StrEnum):
    TRUE_CROP = "true_crop"
    TRUE_EDGE = "true_edge"
    TRUE_CROP_AND_EDGE = "true_crop_and_edge"
    TRUE_CROP_OR_EDGE = "true_crop_or_edge"
    TRUE_CROP_TYPE = "true_crop_type"
    MASK = "mask"
