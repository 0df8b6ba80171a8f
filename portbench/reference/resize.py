"""Bilinear resize with align_corners=True semantics, as dense matmuls
(port of cultionet_tpu/nn/resize.py).

The 1-D interpolations are small dense matrices applied with einsum, so the
arithmetic is the JAX package's, term for term.
"""

from functools import lru_cache

import numpy as np
import torch

Tensor = torch.Tensor


@lru_cache(maxsize=None)
def _interp_matrix(out_size: int, in_size: int) -> np.ndarray:
    """(out_size, in_size) align-corners linear interpolation matrix."""
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    if out_size == 1 or in_size == 1:
        mat[:, 0] = 1.0
        return mat
    coords = np.arange(out_size) * (in_size - 1) / (out_size - 1)
    lo = np.floor(coords).astype(np.int64)
    lo = np.clip(lo, 0, in_size - 2)
    frac = (coords - lo).astype(np.float32)
    mat[np.arange(out_size), lo] = 1.0 - frac
    mat[np.arange(out_size), lo + 1] += frac
    return mat


def _matrix(out_size: int, in_size: int, like: Tensor) -> Tensor:
    return torch.from_numpy(_interp_matrix(out_size, in_size)).to(
        device=like.device, dtype=like.dtype
    )


def resize_bilinear_align_corners(x: Tensor, size) -> Tensor:
    """Resize NCHW ``x`` to spatial ``size=(H, W)`` (align_corners=True)."""
    out_h, out_w = int(size[0]), int(size[1])
    in_h, in_w = x.shape[-2:]
    if (in_h, in_w) == (out_h, out_w):
        return x
    if in_h != out_h:
        x = torch.einsum("hi,bciw->bchw", _matrix(out_h, in_h, x), x)
    if in_w != out_w:
        x = torch.einsum("wj,bchj->bchw", _matrix(out_w, in_w, x), x)
    return x
