"""The Tanimoto-complement loss of the configurations ("TanimotoComplementLoss"),
channel-last, in plain PyTorch.

Predictions are ``(B, H, W, C)``, targets ``(B, H, W)`` integer labels
(classification) or floats (regression), masks ``(B, H, W)`` with 1 =
keep, 0 = ignore. Masked reductions stand in for boolean selects.
"""

import typing as T

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _ensure_channels_last(x: Tensor) -> Tensor:
    """(B, H, W) -> (B, H, W, 1); (B, H, W, C) unchanged."""
    return x[..., None] if x.dim() == 3 else x


def _reduce_dims(x: Tensor) -> T.Tuple[int, ...]:
    return tuple(range(1, x.dim()))


def preprocess(
    inputs: Tensor,
    targets: Tensor,
    mask: T.Optional[Tensor] = None,
    transform_logits: bool = False,
    one_hot_targets: bool = True,
) -> T.Tuple[Tensor, Tensor]:
    """Shared loss preprocessing: sigmoid (one channel) or softmax logits,
    one-hot targets for a multi-channel prediction, and the mask applied to
    both inputs and targets."""
    inputs = _ensure_channels_last(inputs)
    num_classes = inputs.shape[-1]

    if transform_logits:
        if num_classes == 1:
            inputs = torch.sigmoid(inputs)
        else:
            inputs = torch.softmax(inputs, dim=-1)
        inputs = inputs.clamp(0.0, 1.0)

    if one_hot_targets and num_classes > 1:
        targets = F.one_hot(targets.long(), num_classes).to(inputs.dtype)
    else:
        targets = _ensure_channels_last(targets).to(inputs.dtype)

    if mask is not None:
        mask = _ensure_channels_last(mask).to(inputs.dtype)
        inputs = inputs * mask
        targets = targets * mask

    return inputs, targets


def _tanimoto_complement_distance(
    ytrue: Tensor, ypred: Tensor, smooth: float = 1e-5, depth: int = 5
) -> Tensor:
    """FracTAL depth-scaled Tanimoto distance, per sample."""
    dims = _reduce_dims(ypred)
    tpl = (ytrue * ypred).sum(dims)
    sq_sum = (ytrue**2 + ypred**2).sum(dims)

    denominator = torch.zeros_like(tpl)
    for d in range(depth):
        a = 2.0**d
        b = -(2.0 * a - 1.0)
        denominator = denominator + 1.0 / ((a * sq_sum) + (b * tpl) + smooth)

    return 1.0 - ((tpl + smooth) * denominator) * (1.0 / depth)


def tanimoto_complement_loss(
    inputs: Tensor,
    targets: Tensor,
    mask: T.Optional[Tensor] = None,
    smooth: float = 1e-5,
    depth: int = 5,
    transform_logits: bool = False,
    one_hot_targets: bool = True,
) -> Tensor:
    """Symmetric depth-scaled (FracTAL) Tanimoto loss."""
    inputs, targets = preprocess(
        inputs, targets, mask, transform_logits, one_hot_targets
    )
    loss1 = _tanimoto_complement_distance(
        targets, inputs, smooth=smooth, depth=depth
    )
    loss2 = _tanimoto_complement_distance(
        1.0 - targets, 1.0 - inputs, smooth=smooth, depth=depth
    )
    return ((loss1 + loss2) * 0.5).mean()


class TanimotoComplementLoss:
    """``tanimoto_complement_loss`` with its options bound, called as
    ``loss(inputs, targets, mask=None)``."""

    def __init__(
        self,
        smooth: float = 1e-5,
        depth: int = 5,
        transform_logits: bool = False,
        one_hot_targets: bool = True,
    ):
        self.options = dict(
            smooth=smooth,
            depth=depth,
            transform_logits=transform_logits,
            one_hot_targets=one_hot_targets,
        )

    def __call__(self, inputs, targets, mask=None):
        return tanimoto_complement_loss(inputs, targets, mask=mask, **self.options)
