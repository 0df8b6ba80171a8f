"""Magnitude pruning (port of cultionet_tpu/train/prune.py; the
reference's optional Lightning ModelPruning callback, L1-unstructured)."""

import typing as T

import torch

Tensor = torch.Tensor


def l1_unstructured_prune(
    params: T.Mapping[str, Tensor], amount: float = 0.2, min_size: int = 32
) -> T.Dict[str, Tensor]:
    """Zero the smallest-|w| fraction ``amount`` of each weight tensor:
    every entry with ``|w|`` at or below the ``int(n * amount)``-th smallest
    magnitude, so ties at the threshold go too. Tensors with fewer than 2
    dimensions (biases, norm scales) or ``min_size`` elements are kept."""
    out = {}
    for name, leaf in params.items():
        k = int(leaf.numel() * amount)
        if leaf.dim() < 2 or leaf.numel() < min_size or k == 0:
            out[name] = leaf
            continue
        magnitude = leaf.abs()
        threshold = magnitude.reshape(-1).sort().values[k - 1]
        out[name] = torch.where(
            magnitude <= threshold, torch.zeros_like(leaf), leaf
        )
    return out


def sparsity(params: T.Mapping[str, Tensor]) -> float:
    """Fraction of zero entries across all floating-point tensors."""
    zeros = total = 0
    for leaf in params.values():
        if leaf.is_floating_point():
            zeros += int((leaf == 0).sum())
            total += leaf.numel()
    return zeros / max(total, 1)
