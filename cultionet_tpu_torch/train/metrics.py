"""Evaluation metrics (port of cultionet_tpu/train/metrics.py): MAE, MSE,
macro F-beta, Matthews correlation, Dice and IoU, each with an optional
validity mask (invalid pixels get zero weight); and, for class maps, the
overall accuracy and mean IoU of a confusion matrix (``class_scores``)."""

import typing as T

import torch

Tensor = torch.Tensor


def _weights(values: Tensor, mask: T.Optional[Tensor]) -> Tensor:
    if mask is None:
        return torch.ones_like(values, dtype=torch.float32)
    return mask.to(torch.float32)


def mae(
    preds: Tensor, targets: Tensor, mask: T.Optional[Tensor] = None
) -> Tensor:
    w = _weights(preds, mask)
    return ((preds - targets).abs() * w).sum() / w.sum().clamp_min(1.0)


def mse(
    preds: Tensor, targets: Tensor, mask: T.Optional[Tensor] = None
) -> Tensor:
    w = _weights(preds, mask)
    return ((preds - targets) ** 2 * w).sum() / w.sum().clamp_min(1.0)


def confusion_counts(
    preds: Tensor,
    targets: Tensor,
    num_classes: int = 2,
    mask: T.Optional[Tensor] = None,
) -> Tensor:
    """(num_classes, num_classes) confusion matrix; rows = true class."""
    w = _weights(preds, mask).reshape(-1)
    index = targets.reshape(-1).long() * num_classes + preds.reshape(-1).long()
    counts = torch.zeros(
        num_classes * num_classes, dtype=torch.float32, device=preds.device
    )
    return counts.index_add_(0, index, w).reshape(num_classes, num_classes)


def fbeta_score(
    preds: Tensor,
    targets: Tensor,
    beta: float = 2.0,
    num_classes: int = 2,
    mask: T.Optional[Tensor] = None,
) -> Tensor:
    """Macro-averaged multiclass F-beta; classes absent from both preds and
    targets are skipped from the macro mean."""
    cm = confusion_counts(preds, targets, num_classes=num_classes, mask=mask)
    tp = cm.diagonal()
    fn = cm.sum(1) - tp
    fp = cm.sum(0) - tp
    beta2 = beta**2
    denom = (1.0 + beta2) * tp + beta2 * fn + fp
    score = torch.where(
        denom > 0,
        (1.0 + beta2) * tp / denom.clamp_min(1.0),
        torch.zeros_like(denom),
    )
    present = ((cm.sum(1) + cm.sum(0)) > 0).to(torch.float32)
    return (score * present).sum() / present.sum().clamp_min(1.0)


def matthews_corrcoef(
    preds: Tensor,
    targets: Tensor,
    num_classes: int = 2,
    mask: T.Optional[Tensor] = None,
) -> Tensor:
    """Multiclass MCC (R_k statistic) from the confusion matrix."""
    cm = confusion_counts(preds, targets, num_classes=num_classes, mask=mask)
    t_sum = cm.sum(1)
    p_sum = cm.sum(0)
    n = cm.sum()
    correct = cm.diagonal().sum()
    cov_ytyp = correct * n - torch.dot(t_sum, p_sum)
    cov_ypyp = n**2 - torch.dot(p_sum, p_sum)
    cov_ytyt = n**2 - torch.dot(t_sum, t_sum)
    denom = (cov_ypyp * cov_ytyt).clamp_min(0.0).sqrt()
    return torch.where(
        denom > 0, cov_ytyp / denom.clamp_min(1e-12), torch.zeros_like(denom)
    )


def probas_to_labels(x: Tensor, thresh: float = 0.5) -> Tensor:
    """Channel-last probabilities -> integer labels."""
    if x.shape[-1] == 1:
        return (x[..., 0] > thresh).to(torch.int32)
    return x.argmax(-1).to(torch.int32)


def dice_score(
    preds: Tensor,
    targets: Tensor,
    mask: T.Optional[Tensor] = None,
    smooth: float = 1e-8,
) -> Tensor:
    """Binary Dice over labels."""
    w = _weights(preds, mask)
    p = preds.to(torch.float32) * w
    t = targets.to(torch.float32) * w
    return (2.0 * (p * t).sum() + smooth) / (p.sum() + t.sum() + smooth)


def jaccard_score(
    preds: Tensor,
    targets: Tensor,
    mask: T.Optional[Tensor] = None,
    smooth: float = 1e-8,
) -> Tensor:
    """Binary IoU over labels."""
    w = _weights(preds, mask)
    p = preds.to(torch.float32) * w
    t = targets.to(torch.float32) * w
    inter = (p * t).sum()
    return (inter + smooth) / (p.sum() + t.sum() - inter + smooth)


def class_scores(cm: Tensor, void_class: int = -1) -> T.Tuple[Tensor, Tensor]:
    """Overall accuracy and mean IoU of a (K, K) confusion matrix (rows
    the true class), as U-TAE's ``IoU.get_miou_acc`` computes them: the
    void class's row and column dropped, the IoU of each class that
    occurs in the targets or the predictions, averaged."""
    k = cm.shape[0]
    keep = torch.ones(k, dtype=torch.bool, device=cm.device)
    keep[void_class] = False
    cm = cm.float() * keep[:, None] * keep[None, :]
    tp = cm.diagonal()
    union = cm.sum(0) + cm.sum(1) - tp
    present = union > 0
    iou = tp / union.clamp_min(1.0)
    miou = (iou * present).sum() / present.sum().clamp_min(1)
    return tp.sum() / cm.sum().clamp_min(1.0), miou
