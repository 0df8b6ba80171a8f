"""Per-pixel multi-head attention along the time axis: the plain PyTorch
version and the dispatching op (port of the attention core of
cultionet_tpu/models/temporal.py, ``_attend_t_axis``, and of the Pallas
kernel ``ops/temporal_pallas.py``).

Pixel-major layout: ``q`` is ``(N, Tq, C)`` and ``k``, ``v`` are
``(N, S, C)``, with N pixels, ``C = num_heads * head_dim`` and the heads
side by side along C. Every pixel attends over its own S time steps only.

- ``temporal_attention_reference``: the plain version, the CPU path and the
  oracle of the CUDA kernels in ``temporal_cuda.py``.
- ``temporal_inference``: the forward as the registered torch op
  ``cultionet_tpu_torch::temporal_attention``: on a CUDA tensor it
  launches the hand-written kernel ``temporal_fwd``, on a CPU tensor it
  computes the plain version; ``torch.export`` keeps it in a serving
  program.
- ``temporal_attention``: the op the model calls. Where no gradient is
  needed, ``temporal_inference``; else a CUDA tensor goes to the
  differentiable kernels and a CPU tensor to the plain version. On a CUDA
  tensor, after ``ops.flags.set_cuda_temporal(False)``, always the plain
  version.
"""

import torch

from .flags import cuda_temporal_enabled
from .natten import grad_needed

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


@torch.library.custom_op(
    "cultionet_tpu_torch::temporal_attention", mutates_args=()
)
def temporal_inference(q: Tensor, k: Tensor, v: Tensor, num_heads: int) -> Tensor:
    """Temporal attention without gradient, as a registered op: the plain
    version on the CPU (this body), the kernel ``temporal_fwd`` on a CUDA
    tensor. Returns a new contiguous (N, Tq, C) tensor in q's dtype."""
    return temporal_attention_reference(q, k, v, num_heads).contiguous()


@temporal_inference.register_kernel("cuda")
def _temporal_inference_cuda(q, k, v, num_heads):
    from .temporal_cuda import launch_temporal_fwd

    return launch_temporal_fwd(q, k, v, num_heads)


@temporal_inference.register_fake
def _temporal_inference_fake(q, k, v, num_heads):
    check_heads(q.shape[2], num_heads)
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


def temporal_attention(
    q: Tensor, k: Tensor, v: Tensor, num_heads: int
) -> Tensor:
    """Temporal attention on whatever device ``q`` lies on.

    Inference (no gradient): the registered op ``temporal_inference``,
    which an exported program keeps. Training on CUDA: the hand-written
    kernels (``temporal_cuda.temporal_attention_cuda``). The plain version
    on the CPU, and on CUDA after an explicit ``set_cuda_temporal(False)``.
    """
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"temporal attention: unsupported device {q.device}")
    plain_only = q.device.type == "cuda" and not cuda_temporal_enabled()
    if not plain_only and not grad_needed(q, k, v):
        return temporal_inference(q, k, v, num_heads)
    if q.device.type == "cuda" and not plain_only:
        from .temporal_cuda import temporal_attention_cuda

        return temporal_attention_cuda(q, k, v, num_heads)
    return temporal_attention_reference(q, k, v, num_heads)
