"""Compute precision (port of cultionet_tpu/train/precision.py).

"16-mixed" is bf16 compute with fp32 master weights: the train step runs
the model on bf16 copies of the fp32 parameters, so gradients flow back
through the cast and land in fp32, where the optimizer updates them.
"""

import typing as T

import torch

Tensor = torch.Tensor


def cast_floating(
    tensors: T.Mapping[str, T.Optional[Tensor]], dtype: torch.dtype
) -> T.Dict[str, T.Optional[Tensor]]:
    """Cast every floating-point tensor of a mapping to ``dtype`` (a cast
    to the tensor's own type returns the tensor itself)."""
    return {
        name: value.to(dtype)
        if value is not None and value.is_floating_point()
        else value
        for name, value in tensors.items()
    }


def resolve_dtype(precision: str) -> torch.dtype:
    if precision in ("bf16", "bfloat16", "16-mixed"):
        return torch.bfloat16
    if precision in ("fp32", "float32", "32"):
        return torch.float32
    raise ValueError(f"Unknown precision: {precision!r}")
