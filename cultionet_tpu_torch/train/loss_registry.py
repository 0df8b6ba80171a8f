"""Loss registry: name -> {classification, regression} callables (port of
cultionet_tpu/train/loss_registry.py)."""

import typing as T

from ..enums import LossTypes
from ..losses import (
    BoundaryLoss,
    ClassBalancedMSELoss,
    CombinedLoss,
    CrossEntropyLoss,
    FocalTverskyLoss,
    LogCoshLoss,
    TanimotoComplementLoss,
    TanimotoDistLoss,
    TverskyLoss,
)


def build_loss_dict() -> T.Dict[str, T.Dict[str, T.Callable]]:
    return {
        LossTypes.BOUNDARY: {
            "classification": BoundaryLoss(),
        },
        LossTypes.CROSS_ENTROPY: {
            "classification": CrossEntropyLoss(),
        },
        LossTypes.CLASS_BALANCED_MSE: {
            "classification": ClassBalancedMSELoss(),
        },
        LossTypes.LOG_COSH: {
            "regression": LogCoshLoss(),
        },
        LossTypes.TANIMOTO_COMPLEMENT: {
            "classification": TanimotoComplementLoss(),
            "regression": TanimotoComplementLoss(
                transform_logits=False, one_hot_targets=False
            ),
        },
        LossTypes.TANIMOTO: {
            "classification": TanimotoDistLoss(),
            "regression": TanimotoDistLoss(
                transform_logits=False, one_hot_targets=False
            ),
        },
        LossTypes.TANIMOTO_COMBINED: {
            "classification": CombinedLoss(
                losses=[TanimotoDistLoss(), TanimotoComplementLoss()]
            ),
            "regression": CombinedLoss(
                losses=[
                    TanimotoDistLoss(
                        transform_logits=False, one_hot_targets=False
                    ),
                    TanimotoComplementLoss(
                        transform_logits=False, one_hot_targets=False
                    ),
                ]
            ),
        },
        LossTypes.TVERSKY: {
            "classification": TverskyLoss(),
        },
        LossTypes.FOCAL_TVERSKY: {
            "classification": FocalTverskyLoss(),
        },
    }


LOSS_DICT = build_loss_dict()
