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
- ``dropout_keep_mask``: the attention-dropout mask of the CUDA kernels,
  bit for bit, as a tensor the plain version applies through its
  ``weights_fn`` hook.
- ``na2d``: the op the model calls. A CUDA tensor goes to the hand-written
  kernels (unless ``ops.flags.set_cuda_natten(False)`` was called), a CPU
  tensor to the plain version.

All take ``q, k, v`` shaped ``(B, H, W, num_heads, head_dim)`` and return the
same shape.
"""

import math
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


def check_dropout_rate(attn_drop: float) -> None:
    if not 0.0 <= attn_drop < 1.0:
        raise ValueError(
            f"attention dropout rate must be in [0, 1), got {attn_drop}"
        )


_MASK32 = 0xFFFFFFFF


def _mul32(x: Tensor, constant: int) -> Tensor:
    """(x * constant) mod 2^32 for int64 ``x`` in [0, 2^32), with every
    intermediate below 2^63 (split into 16-bit halves)."""
    high = ((x >> 16) * constant) & 0xFFFF
    return ((x & 0xFFFF) * constant + (high << 16)) & _MASK32


def _mix32(x: Tensor) -> Tensor:
    """na2d_common.cuh::mix32 on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def dropout_keep_mask(
    seed: T.Union[int, Tensor], shape: T.Sequence[int], attn_drop: float
) -> Tensor:
    """Inverted-dropout mask of the attention weights, shaped
    ``(B, H, W, heads, k*k)`` as ``shape`` says: ``1 / (1 - attn_drop)``
    where the weight is kept, else 0, in fp32.

    It computes the CUDA kernels' keep bits (``csrc/na2d_common.cuh``) with
    torch integer ops: the bit of window slot ``j`` of query-head ``q`` (the
    flat index of (b, h, w, head)) is a hash of (seed, q, j), kept when its
    top 24 bits reach ``ceil(attn_drop * 2^24)``. So the plain version, fed
    this mask, and the kernels drop the same weights, whatever their launch
    geometry. ``seed`` is an int (the mask is made on the CPU) or a
    one-element integer tensor (the mask is made on its device, without a
    host sync).
    """
    check_dropout_rate(attn_drop)
    *lead, slots = shape
    if not isinstance(seed, Tensor):
        seed = torch.tensor(int(seed))
    device = seed.device
    seed = seed.reshape(()).to(torch.int64)
    query = torch.arange(math.prod(lead), device=device)[:, None]
    slot = torch.arange(slots, device=device)[None, :]
    x = _mix32((seed & _MASK32) ^ 0x9E3779B9)
    x = _mix32(x ^ (query & _MASK32))
    x = _mix32(x ^ (query >> 32))
    x = _mix32(x ^ slot)
    keep = (x >> 8) >= math.ceil(attn_drop * (1 << 24))
    # Multiplied in fp32, as the kernels' float 1 / (1 - p).
    scale = 1.0 / (1.0 - attn_drop)
    return (keep.to(torch.float32) * scale).reshape(*lead, slots)


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
    q: Tensor,
    k: Tensor,
    v: Tensor,
    kernel_size: int,
    dilation: int = 1,
    attn_drop: float = 0.0,
    seed: T.Optional[Tensor] = None,
) -> Tensor:
    """Neighborhood attention on whatever device ``q`` lies on, with
    inverted dropout on the attention weights when ``attn_drop > 0``
    (keep bits from ``seed``, a one-element int32 tensor on q's device).

    CUDA: the hand-written kernels (``natten_cuda.na2d_cuda``), or the plain
    version after an explicit ``set_cuda_natten(False)``. CPU: the plain
    version, given ``dropout_keep_mask(seed, ...)`` through its hook.
    """
    if q.device.type == "cuda" and cuda_natten_enabled():
        from .natten_cuda import na2d_cuda

        return na2d_cuda(q, k, v, kernel_size, dilation, attn_drop, seed)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"na2d: unsupported device {q.device}")
    weights_fn = None
    if attn_drop > 0:
        if seed is None:
            raise ValueError("na2d: attention dropout needs a seed")

        def weights_fn(weights: Tensor) -> Tensor:
            mask = dropout_keep_mask(seed, weights.shape, attn_drop)
            return weights * mask.to(weights.dtype)

    return neighborhood_attention_2d(
        q, k, v, kernel_size, dilation, weights_fn=weights_fn
    )
