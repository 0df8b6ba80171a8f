"""Per-pixel multi-head attention along the time axis: the plain PyTorch
version and the dispatching op (port of the attention core of
cultionet_tpu/models/temporal.py, ``_attend_t_axis``, and of the Pallas
kernel ``ops/temporal_pallas.py``).

Pixel-major layout: ``q`` is ``(N, Tq, C)`` and ``k``, ``v`` are
``(N, S, C)``, with N pixels, ``C = num_heads * head_dim`` and the heads
side by side along C. Every pixel attends over its own S time steps only.

- ``temporal_attention_reference``: the plain version, the CPU path and the
  oracle of the CUDA kernels in ``temporal_cuda.py``.
- ``temporal_attention``: the op the model calls. A CUDA tensor goes to the
  hand-written kernels (unless ``ops.flags.set_cuda_temporal(False)`` was
  called), a CPU tensor to the plain version.
"""

import torch

from .flags import cuda_temporal_enabled

Tensor = torch.Tensor


def check_heads(channels: int, num_heads: int) -> int:
    """The head size; raises unless ``num_heads`` divides ``channels``."""
    if num_heads < 1 or channels % num_heads:
        raise ValueError(
            f"temporal attention: {num_heads} heads do not divide "
            f"{channels} channels"
        )
    return channels // num_heads


def temporal_attention_reference(
    q: Tensor, k: Tensor, v: Tensor, num_heads: int
) -> Tensor:
    """softmax(q k^T / sqrt(head_dim)) v per pixel and head, over S.

    q: (N, Tq, C); k, v: (N, S, C) -> (N, Tq, C) in q's dtype. q is scaled
    by head_dim^-0.5 in fp32; logits, softmax and the weighted sum are fp32,
    and the output is cast once, as the Pallas kernel does
    (``temporal_pallas.py::_fwd_kernel``).
    """
    n, tq, c = q.shape
    head_dim = check_heads(c, num_heads)
    qh = q.float().reshape(n, tq, num_heads, head_dim) * head_dim**-0.5
    kh = k.float().reshape(n, k.shape[1], num_heads, head_dim)
    vh = v.float().reshape(n, v.shape[1], num_heads, head_dim)
    weights = torch.softmax(torch.einsum("nthd,nshd->nhts", qh, kh), dim=-1)
    out = torch.einsum("nhts,nshd->nthd", weights, vh)
    return out.reshape(n, tq, c).to(q.dtype)


def temporal_attention(
    q: Tensor, k: Tensor, v: Tensor, num_heads: int
) -> Tensor:
    """Temporal attention on whatever device ``q`` lies on.

    CUDA: the hand-written kernels (``temporal_cuda.temporal_attention_cuda``),
    or the plain version after an explicit ``set_cuda_temporal(False)``.
    CPU: the plain version.
    """
    if q.device.type == "cuda" and cuda_temporal_enabled():
        from .temporal_cuda import temporal_attention_cuda

        return temporal_attention_cuda(q, k, v, num_heads)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"temporal attention: unsupported device {q.device}")
    return temporal_attention_reference(q, k, v, num_heads)
