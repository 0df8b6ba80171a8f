"""Multi-task segmentation losses in PyTorch, channel-last (port of
cultionet_tpu/losses/losses.py).

Layout, as in the JAX package: predictions are ``(B, H, W, C)``, targets
``(B, H, W)`` integer labels (classification) or floats (regression), masks
``(B, H, W)`` with 1 = keep, 0 = ignore. Masked reductions stand in for
boolean selects, so every loss is a fixed-shape tensor expression.
"""

import math
import typing as T
from functools import partial

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


def _tanimoto_distance(
    ypred: Tensor, ytrue: Tensor, smooth: float = 1e-5
) -> Tensor:
    """Per-sample Tanimoto distance, reduced over (H, W, C)."""
    ytrue = ytrue.to(ypred.dtype)
    dims = _reduce_dims(ypred)
    tpl = (ypred * ytrue).sum(dims)
    sq_sum = (ypred**2 + ytrue**2).sum(dims)
    return 1.0 - (tpl + smooth) / ((sq_sum - tpl) + smooth)


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


def tanimoto_dist_loss(
    inputs: Tensor,
    targets: Tensor,
    mask: T.Optional[Tensor] = None,
    smooth: float = 1e-5,
    transform_logits: bool = False,
    one_hot_targets: bool = True,
) -> Tensor:
    """Symmetric (with-complement) Tanimoto distance loss."""
    inputs, targets = preprocess(
        inputs, targets, mask, transform_logits, one_hot_targets
    )
    loss1 = _tanimoto_distance(inputs, targets, smooth=smooth)
    loss2 = _tanimoto_distance(1.0 - inputs, 1.0 - targets, smooth=smooth)
    return ((loss1 + loss2) * 0.5).mean()


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


def _masked_mean(loss: Tensor, mask: T.Optional[Tensor]) -> Tensor:
    if mask is None:
        return loss.mean()
    mask = _ensure_channels_last(mask).to(loss.dtype)
    return (loss * mask).sum() / mask.sum().clamp_min(1.0)


def log_cosh_loss(
    inputs: Tensor, targets: Tensor, mask: T.Optional[Tensor] = None
) -> Tensor:
    """log(cosh(pred - target)) = x + softplus(-2x) - log 2; masked mean
    when a mask is given."""
    inputs = _ensure_channels_last(inputs)
    diff = inputs - _ensure_channels_last(targets).to(inputs.dtype)
    loss = diff + F.softplus(-2.0 * diff) - math.log(2.0)
    return _masked_mean(loss, mask)


def class_balanced_mse_loss(
    inputs: Tensor, targets: Tensor, mask: T.Optional[Tensor] = None
) -> Tensor:
    """Class-balanced MSE with log-cosh smoothing; an empty class adds 0."""
    if inputs.dim() == 4:
        inputs = inputs[..., 0]
    if targets.dim() == 4:
        targets = targets[..., 0]
    targets = targets.to(inputs.dtype)

    if mask is not None:
        if mask.dim() == 4:
            mask = mask[..., 0]
        valid = mask != 0
        neg_mask = (targets <= 0.5) & valid
        pos_mask = (targets > 0.5) & valid
        target_count = mask.to(inputs.dtype).sum()
    else:
        neg_mask = targets <= 0.5
        pos_mask = ~neg_mask
        # Filled on the device: no copy from the host.
        target_count = torch.full(
            (), float(targets.numel()), dtype=inputs.dtype, device=inputs.device
        )

    sq = (inputs - targets) ** 2
    logcosh = sq + F.softplus(-2.0 * sq) - math.log(2.0)

    def masked_mean(values: Tensor, m: Tensor) -> Tensor:
        m = m.to(values.dtype)
        count = m.sum()
        total = (values * m).sum()
        return torch.where(
            count > 0, total / count.clamp_min(1.0), torch.zeros_like(total)
        )

    neg_loss = masked_mean(logcosh, neg_mask)
    pos_loss = masked_mean(logcosh, pos_mask)
    beta = pos_mask.to(inputs.dtype).sum() / target_count.clamp_min(1.0)
    return beta * neg_loss + (1.0 - beta) * pos_loss


def boundary_loss(
    inputs: Tensor, targets: Tensor, mask: T.Optional[Tensor] = None
) -> Tensor:
    """Kervadec boundary loss: 1 - mean(pred * distance_map)."""
    inputs = _ensure_channels_last(inputs)
    targets = _ensure_channels_last(targets).to(inputs.dtype)
    if mask is not None:
        mask = _ensure_channels_last(mask).to(inputs.dtype)
        hadamard = (inputs * mask) * (targets * mask)
        return 1.0 - hadamard.sum() / mask.sum().clamp_min(1.0)
    return 1.0 - (inputs * targets).mean()


def _max_pool_2d(x: Tensor, window: T.Tuple[int, int]) -> Tensor:
    """Same-size max pool over (H, W) of an NHWC tensor (odd windows)."""
    wh, ww = window
    pooled = F.max_pool2d(
        x.permute(0, 3, 1, 2),
        kernel_size=(wh, ww),
        stride=1,
        padding=(wh // 2, ww // 2),
    )
    return pooled.permute(0, 2, 3, 1)


def soft_skeleton(x: Tensor, num_iter: int = 10) -> Tensor:
    """Morphological soft skeleton (clDice), NHWC: soft_erode is the min of
    two 1-D erosions, soft_dilate a 3x3 max pool."""

    def soft_erode(img: Tensor) -> Tensor:
        p1 = -_max_pool_2d(-img, (3, 1))
        p2 = -_max_pool_2d(-img, (1, 3))
        return torch.minimum(p1, p2)

    def soft_open(img: Tensor) -> Tensor:
        return _max_pool_2d(soft_erode(img), (3, 3))

    skeleton = F.relu(x - soft_open(x))
    img = x
    for _ in range(num_iter):
        img = soft_erode(img)
        delta = F.relu(img - soft_open(img))
        skeleton = skeleton + F.relu(delta - skeleton * delta)
    return skeleton


def cl_dice_loss(
    inputs: Tensor,
    targets: Tensor,
    mask: T.Optional[Tensor] = None,
    smooth: float = 1.0,
    num_iter: int = 10,
    transform_logits: bool = True,
) -> Tensor:
    """Centerline Dice loss."""
    inputs = _ensure_channels_last(inputs)
    targets = _ensure_channels_last(targets).to(inputs.dtype)

    if transform_logits:
        inputs = torch.softmax(inputs, dim=-1)[..., 1:2]

    y_pred = (inputs > 0.5).to(inputs.dtype)
    y_pred = torch.cat([1.0 - y_pred, y_pred], dim=-1)
    y_true = torch.cat([1.0 - targets, targets], dim=-1)

    if mask is not None:
        mask = _ensure_channels_last(mask).to(inputs.dtype)
        y_true = y_true * mask
        y_pred = y_pred * mask

    pred_skeleton = soft_skeleton(y_pred, num_iter=num_iter)
    true_skeleton = soft_skeleton(y_true, num_iter=num_iter)

    def precision_recall(skel: Tensor, m: Tensor) -> Tensor:
        return ((skel * m).sum() + smooth) / (skel.sum() + smooth)

    topo_precision = precision_recall(pred_skeleton, y_true)
    topo_recall = precision_recall(true_skeleton, y_pred)
    return 1.0 - 2.0 * (topo_precision * topo_recall) / (
        topo_precision + topo_recall
    )


def tversky_loss(
    inputs: Tensor,
    targets: Tensor,
    mask: T.Optional[Tensor] = None,
    alpha: float = 0.4,
    beta: float = 0.6,
    smooth: float = 1.0,
    transform_logits: bool = False,
    one_hot_targets: bool = True,
) -> Tensor:
    """Tversky loss."""
    inputs, targets = preprocess(
        inputs, targets, mask, transform_logits, one_hot_targets
    )
    dims = _reduce_dims(inputs)
    tp = (inputs * targets).sum(dims)
    fp = ((1.0 - targets) * inputs).sum(dims)
    fn = (targets * (1.0 - inputs)).sum(dims)
    tversky = (tp + smooth) / (tp + alpha * fp + beta * fn + smooth)
    return (1.0 - tversky).mean()


def focal_tversky_loss(
    inputs: Tensor,
    targets: Tensor,
    mask: T.Optional[Tensor] = None,
    alpha: float = 0.2,
    beta: float = 0.8,
    gamma: float = 2.0,
    smooth: float = 1.0,
) -> Tensor:
    """Focal Tversky loss."""
    loss = tversky_loss(
        inputs, targets, mask=mask, alpha=alpha, beta=beta, smooth=smooth
    )
    return loss**gamma


class CombinedLoss:
    """Mean of several losses."""

    def __init__(self, losses: T.Sequence[T.Callable]):
        self.losses = tuple(losses)

    def __call__(self, inputs, targets, mask=None):
        total = 0.0
        for fn in self.losses:
            total = total + fn(inputs, targets, mask=mask)
        return total / len(self.losses)


class _Partial:
    """A loss function with its options bound, called as
    ``loss(inputs, targets, mask=None)``."""

    fn: T.Callable

    def __init__(self, **options):
        self._fn = partial(type(self).fn, **options)

    def __call__(self, inputs, targets, mask=None):
        return self._fn(inputs, targets, mask=mask)


class TanimotoDistLoss(_Partial):
    fn = staticmethod(tanimoto_dist_loss)

    def __init__(
        self,
        smooth: float = 1e-5,
        transform_logits: bool = False,
        one_hot_targets: bool = True,
    ):
        super().__init__(
            smooth=smooth,
            transform_logits=transform_logits,
            one_hot_targets=one_hot_targets,
        )


class TanimotoComplementLoss(_Partial):
    fn = staticmethod(tanimoto_complement_loss)

    def __init__(
        self,
        smooth: float = 1e-5,
        depth: int = 5,
        transform_logits: bool = False,
        one_hot_targets: bool = True,
    ):
        super().__init__(
            smooth=smooth,
            depth=depth,
            transform_logits=transform_logits,
            one_hot_targets=one_hot_targets,
        )


class LogCoshLoss(_Partial):
    fn = staticmethod(log_cosh_loss)


class ClassBalancedMSELoss(_Partial):
    fn = staticmethod(class_balanced_mse_loss)


class BoundaryLoss(_Partial):
    fn = staticmethod(boundary_loss)


class CLDiceLoss:
    def __init__(self, smooth: float = 1.0, num_iter: int = 10):
        self.smooth = smooth
        self.num_iter = num_iter

    def __call__(self, inputs, targets, mask=None, transform_logits=True):
        return cl_dice_loss(
            inputs,
            targets,
            mask=mask,
            smooth=self.smooth,
            num_iter=self.num_iter,
            transform_logits=transform_logits,
        )


class TverskyLoss(_Partial):
    fn = staticmethod(tversky_loss)

    def __init__(
        self,
        alpha: float = 0.4,
        beta: float = 0.6,
        smooth: float = 1.0,
        transform_logits: bool = False,
        one_hot_targets: bool = True,
    ):
        super().__init__(
            alpha=alpha,
            beta=beta,
            smooth=smooth,
            transform_logits=transform_logits,
            one_hot_targets=one_hot_targets,
        )


class FocalTverskyLoss(_Partial):
    fn = staticmethod(focal_tversky_loss)

    def __init__(
        self,
        alpha: float = 0.2,
        beta: float = 0.8,
        gamma: float = 2.0,
        smooth: float = 1.0,
    ):
        super().__init__(alpha=alpha, beta=beta, gamma=gamma, smooth=smooth)


def class_targets(y: Tensor, num_classes: int, void_class: int) -> Tensor:
    """Integer labels as cross-entropy targets (int64): a label outside
    [0, num_classes) (-1, unlabeled) becomes the void class."""
    y = y.to(torch.int64)
    return torch.where((y >= 0) & (y < num_classes), y, void_class % num_classes)


class CrossEntropyLoss:
    """Class-weighted cross-entropy of channel-last logits (B, H, W, K)
    against (B, H, W) labels, the mean over the pixels' weights: every
    class weighs 1 but ``void_class`` (U-TAE's ``train_semantic.py`` sets
    ``weights[ignore_index] = 0``, -1 the last class), which weighs 0."""

    def __init__(self, void_class: int = -1):
        self.void_class = void_class

    def __call__(self, logits: Tensor, y: Tensor) -> Tensor:
        k = logits.shape[-1]
        # Made on the device, with no copy from the host (a CUDA graph
        # captures the loss).
        classes = torch.arange(k, device=logits.device)
        weight = (classes != self.void_class % k).to(torch.float32)
        target = class_targets(y, k, self.void_class)
        logits = logits.permute(0, 3, 1, 2)
        logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
        return F.cross_entropy(logits, target, weight=weight.to(logits.dtype))


class MaskedCrossEntropyLoss:
    """Cross-entropy of channel-last logits (B, H, W, K) against (B, H, W)
    labels, the mean over the pixels whose label is one of the K classes:
    a label outside [0, K) (void, -1 unlabeled) has no logit and is left
    out (TSViT's ``masked_cross_entropy``, whose 19 classes leave out
    PASTIS's void, 19)."""

    def __call__(self, logits: Tensor, y: Tensor) -> Tensor:
        k = logits.shape[-1]
        y = y.to(torch.int64)
        logits = logits.permute(0, 3, 1, 2)
        logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
        # -100 is ``F.cross_entropy``'s ``ignore_index``.
        return F.cross_entropy(logits, torch.where((y >= 0) & (y < k), y, -100))
