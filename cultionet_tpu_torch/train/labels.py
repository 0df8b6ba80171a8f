"""Label derivation from raw chip labels (port of
cultionet_tpu/train/labels.py).

y encodes -1 = unlabeled (weak supervision), 0 = background,
1..edge_class-1 = crop classes, edge_class = field boundary. The mask is
always computed (all ones when no -1 pixel exists).
"""

import typing as T

import torch

from ..enums import ValidationNames

Tensor = torch.Tensor


def get_true_labels(y: Tensor, edge_class: int = 2) -> T.Dict[str, Tensor]:
    crop = (y > 0) & (y < edge_class)
    edge = y == edge_class
    return {
        ValidationNames.TRUE_EDGE: edge.to(torch.int32),
        ValidationNames.TRUE_CROP: crop.to(torch.int32),
        ValidationNames.TRUE_CROP_AND_EDGE: (y > 0).to(torch.int32),
        ValidationNames.TRUE_CROP_OR_EDGE: crop.to(torch.int32)
        + 2 * edge.to(torch.int32),
        ValidationNames.MASK: (y != -1).to(torch.int32),
    }
