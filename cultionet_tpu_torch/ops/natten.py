"""2-D (dilated) neighborhood attention: the plain PyTorch version and the
dispatching op (port of cultionet_tpu/ops/natten.py).

NATTEN semantics: every query attends to a ``kernel_size x kernel_size``
window of keys. Near the borders the window *slides inward* (clamped window
start), so each query always attends to exactly ``k*k`` keys; with dilation
``d`` the window is composed within the query's (h % d, w % d) coset.

- ``neighborhood_attention_2d``: the plain version. Each of the k*k shifted
  key/value tensors is built from static slices and concatenation; it is the
  CPU path and the oracle of the CUDA kernel in ``natten_cuda.py``.
- ``neighborhood_attention_2d_ref``: a gather-based oracle for tests.
- ``na2d``: the op the model calls. A CUDA tensor goes to the hand-written
  kernel (unless ``ops.flags.set_cuda_natten(False)`` was called), a CPU
  tensor to the plain version.

All take ``q, k, v`` shaped ``(B, H, W, num_heads, head_dim)`` and return the
same shape.
"""

import typing as T

import numpy as np
import torch

from .flags import cuda_natten_enabled

Tensor = torch.Tensor


def _axis_neighbor_indices(
    length: int, kernel_size: int, dilation: int
) -> np.ndarray:
    """Static (length, kernel_size) table of neighbor indices along one axis
    under NATTEN clamped-window semantics with dilation."""
    idx = np.empty((length, kernel_size), dtype=np.int64)
    half = kernel_size // 2
    for i in range(length):
        coset = i % dilation
        pos = i // dilation
        coset_len = (length - coset + dilation - 1) // dilation
        start = min(max(pos - half, 0), coset_len - kernel_size)
        idx[i] = coset + dilation * (start + np.arange(kernel_size))
    return idx


def check_spatial(height: int, width: int, kernel_size: int, dilation: int):
    if min(height, width) < kernel_size * dilation:
        raise ValueError(
            f"Spatial dims ({height}x{width}) must be >= "
            f"kernel_size*dilation ({kernel_size * dilation})."
        )


def neighborhood_attention_2d_ref(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    kernel_size: int,
    dilation: int = 1,
    weights_fn: T.Optional[T.Callable[[Tensor], Tensor]] = None,
) -> Tensor:
    """Gather-based oracle (exact for any shape)."""
    batch, height, width, heads, head_dim = q.shape
    check_spatial(height, width, kernel_size, dilation)
    ks = kernel_size

    idx_h = torch.from_numpy(
        _axis_neighbor_indices(height, ks, dilation).reshape(-1)
    ).to(q.device)
    idx_w = torch.from_numpy(
        _axis_neighbor_indices(width, ks, dilation).reshape(-1)
    ).to(q.device)

    def neighbors(x: Tensor) -> Tensor:
        # (B, H, kh, W, N, D) then (B, H, kh, W, kw, N, D)
        x = x.index_select(1, idx_h).reshape(
            batch, height, ks, width, heads, head_dim
        )
        return x.index_select(3, idx_w).reshape(
            batch, height, ks, width, ks, heads, head_dim
        )

    scale = head_dim**-0.5
    logits = torch.einsum("bhwnd,bhiwjnd->bhwnij", q * scale, neighbors(k))
    weights = torch.softmax(logits.reshape(*logits.shape[:4], ks * ks), -1)
    if weights_fn is not None:
        weights = weights_fn(weights)
    weights = weights.reshape(*weights.shape[:4], ks, ks)
    return torch.einsum("bhwnij,bhiwjnd->bhwnd", weights, neighbors(v))


def _clamped_shift(
    x: Tensor, kernel_size: int, j: int, dim: int, dilation: int = 1
) -> Tensor:
    """Dilated clamped-window shift along one image axis using only static
    slices and concatenation.

    For a query at position ``p`` with coset position ``pos = p // d``:
    ``out[p] = x[coset + d * (clip(pos - k//2, 0, len - k) + j)]``. The index
    map is monotone with plateaus of ``d * k//2`` positions at each border,
    so it is a concat of: the border slice tiled ``k//2`` times, the shifted
    interior, and the far-border slice tiled ``k//2`` times. Exact for any
    length, ragged cosets included.
    """
    length = x.shape[dim]
    half = kernel_size // 2
    d = dilation
    if half == 0:
        return x

    middle = x.narrow(dim, d * j, length - 2 * d * half)
    first = [x.narrow(dim, d * j, d)] * half
    last = [x.narrow(dim, length + d * (j - kernel_size), d)] * half
    return torch.cat(first + [middle] + last, dim=dim)


def neighborhood_attention_2d(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    kernel_size: int,
    dilation: int = 1,
    weights_fn: T.Optional[T.Callable[[Tensor], Tensor]] = None,
) -> Tensor:
    """Plain neighborhood attention; exact NATTEN semantics.

    q, k, v: (B, H, W, num_heads, head_dim) -> (B, H, W, num_heads, head_dim)

    ``weights_fn`` (optional) is applied to the post-softmax attention
    weights (the hook attention dropout uses). q is scaled in its own dtype,
    as the JAX plain path does.
    """
    _, height, width, _, head_dim = q.shape
    check_spatial(height, width, kernel_size, dilation)

    if kernel_size == 1:
        # A one-key window's softmax weight is identically 1: out == v.
        if weights_fn is None:
            return v
        ones = torch.ones(v.shape[:4] + (1,), dtype=v.dtype, device=v.device)
        return weights_fn(ones)[..., 0:1] * v

    qs = q * torch.tensor(head_dim**-0.5, dtype=q.dtype, device=q.device)

    logits = []
    shifted_v = []
    for jh in range(kernel_size):
        k_h = _clamped_shift(k, kernel_size, jh, dim=1, dilation=dilation)
        v_h = _clamped_shift(v, kernel_size, jh, dim=1, dilation=dilation)
        for jw in range(kernel_size):
            k_hw = _clamped_shift(k_h, kernel_size, jw, dim=2, dilation=dilation)
            logits.append((qs * k_hw).sum(-1))
            shifted_v.append(
                _clamped_shift(v_h, kernel_size, jw, dim=2, dilation=dilation)
            )

    weights = torch.softmax(torch.stack(logits, -1), -1)  # (B, H, W, N, k*k)
    if weights_fn is not None:
        weights = weights_fn(weights)

    out = torch.zeros_like(v)
    for idx, v_hw in enumerate(shifted_v):
        out = out + weights[..., idx, None] * v_hw
    return out


def na2d(
    q: Tensor, k: Tensor, v: Tensor, kernel_size: int, dilation: int = 1
) -> Tensor:
    """Neighborhood attention on whatever device ``q`` lies on.

    CUDA: the hand-written kernel (``natten_cuda.na2d_cuda``), or the plain
    version after an explicit ``set_cuda_natten(False)``. CPU: the plain
    version.
    """
    if q.device.type == "cuda" and cuda_natten_enabled():
        from .natten_cuda import na2d_cuda

        return na2d_cuda(q, k, v, kernel_size, dilation)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"na2d: unsupported device {q.device}")
    return neighborhood_attention_2d(q, k, v, kernel_size, dilation)
