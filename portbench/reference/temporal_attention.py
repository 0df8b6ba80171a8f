"""Per-pixel multi-head attention along the time axis, in plain PyTorch.

Pixel-major layout: ``q`` is ``(N, Tq, C)`` and ``k``, ``v`` are
``(N, S, C)``, with N pixels, ``C = num_heads * head_dim`` and the heads
side by side along C. Every pixel attends over its own S time steps only.
``temporal_attention`` is the op the reference model calls, on any device.
"""

import torch


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
    and the output is cast once to q's dtype.
    """
    n, tq, c = q.shape
    head_dim = check_heads(c, num_heads)
    qh = q.float().reshape(n, tq, num_heads, head_dim) * head_dim**-0.5
    kh = k.float().reshape(n, k.shape[1], num_heads, head_dim)
    vh = v.float().reshape(n, v.shape[1], num_heads, head_dim)
    weights = torch.softmax(torch.einsum("nthd,nshd->nhts", qh, kh), dim=-1)
    out = torch.einsum("nhts,nshd->nthd", weights, vh)
    return out.reshape(n, tq, c).to(q.dtype)


temporal_attention = temporal_attention_reference
