"""Compute precision (port of cultionet_tpu/train/precision.py)."""

import torch


def resolve_dtype(precision: str) -> torch.dtype:
    if precision in ("bf16", "bfloat16", "16-mixed"):
        return torch.bfloat16
    if precision in ("fp32", "float32", "32"):
        return torch.float32
    raise ValueError(f"Unknown precision: {precision!r}")
