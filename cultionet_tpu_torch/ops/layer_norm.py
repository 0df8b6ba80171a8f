"""LayerNorm over the last axis: the plain version and the dispatching op.
It replaces no TPU kernel (XLA fuses LayerNorm on the TPU); the transformer
temporal front end (``models/temporal.py::TemporalTransformer``) normalises
millions of narrow rows, one pixel's step each, and TSViT
(``models/tsvit.py``) its token rows, where PyTorch's kernels leave most of
their threads idle.

- ``layer_norm_reference``: the plain version, ``F.layer_norm`` itself, the
  CPU path and the oracle of the CUDA kernel in ``layer_norm_cuda.py``.
- ``layer_norm_inference``: the forward as the registered torch op
  ``cultionet_tpu_torch::layer_norm_rows``: on a CUDA tensor it launches
  the hand-written kernel ``layer_norm_rows_fwd``, on a CPU tensor it
  computes the plain version; ``torch.export`` keeps it in a serving
  program.
- ``layer_norm_rows``: what the models call. Where a gradient is needed,
  on CUDA tensors the training kernels (``layer_norm_cuda.
  layer_norm_rows_cuda``: the forward with statistics and its backward,
  which a CUDA graph of the step captures), on CPU tensors
  ``F.layer_norm``; else the registered op, which on a CUDA tensor always
  runs the kernel.
"""

import torch
import torch.nn.functional as F

from .natten import grad_needed

Tensor = torch.Tensor


def layer_norm_reference(
    x: Tensor, weight: Tensor, bias: Tensor, eps: float
) -> Tensor:
    """LayerNorm of ``x`` over its last axis with ``weight`` and ``bias``."""
    return F.layer_norm(x, (x.shape[-1],), weight, bias, eps)


@torch.library.custom_op("cultionet_tpu_torch::layer_norm_rows", mutates_args=())
def layer_norm_inference(
    x: Tensor, weight: Tensor, bias: Tensor, eps: float
) -> Tensor:
    """LayerNorm over the last axis without gradient, as a registered op:
    the plain version on the CPU (this body), the kernel
    ``layer_norm_rows_fwd`` on a CUDA tensor. Returns a new contiguous
    tensor shaped and typed like x."""
    return layer_norm_reference(x, weight, bias, eps).contiguous()


@layer_norm_inference.register_kernel("cuda")
def _layer_norm_inference_cuda(x, weight, bias, eps):
    from .layer_norm_cuda import launch_layer_norm_rows

    return launch_layer_norm_rows(x, weight, bias, eps)


@layer_norm_inference.register_fake
def _layer_norm_inference_fake(x, weight, bias, eps):
    return torch.empty(x.shape, dtype=x.dtype, device=x.device)


def layer_norm_rows(x: Tensor, weight: Tensor, bias: Tensor, eps: float) -> Tensor:
    """LayerNorm of ``x`` over its last axis on whatever device it lies on:
    where autograd would record it, the training kernels on CUDA and
    ``F.layer_norm`` on the CPU; else the registered op
    ``layer_norm_inference``."""
    if not grad_needed(x, weight, bias):
        return layer_norm_inference(x, weight, bias, eps)
    if x.device.type == "cuda":
        from .layer_norm_cuda import layer_norm_rows_cuda

        return layer_norm_rows_cuda(x, weight, bias, eps)
    return layer_norm_reference(x, weight, bias, eps)
