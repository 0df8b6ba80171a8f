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
    MaskedCrossEntropyLoss,
    TanimotoComplementLoss,
    TanimotoDistLoss,
    TverskyLoss,
)


# The losses of class logits alone (``crop_type`` against ``y``): U-TAE's,
# whose last logit is void, and TSViT's, which has no void logit.
CLASS_LOSSES = (LossTypes.CROSS_ENTROPY, LossTypes.MASKED_CROSS_ENTROPY)


def build_loss_dict() -> T.Dict[str, T.Dict[str, T.Callable]]:
    return {
        LossTypes.BOUNDARY: {
            "classification": BoundaryLoss(),
        },
        LossTypes.CROSS_ENTROPY: {
            "classification": CrossEntropyLoss(),
        },
        LossTypes.MASKED_CROSS_ENTROPY: {
            "classification": MaskedCrossEntropyLoss(),
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
