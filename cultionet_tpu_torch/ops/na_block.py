"""The fused LayerNorm -> QKV -> neighborhood attention -> projection ->
LayerNorm block (port of the bottom of cultionet_tpu/ops/natten_pallas.py).

``x`` is ``(B, H, W, C)`` (fp32 or bf16) and ``params`` holds the JAX
block's eight arrays under its keys and layouts (``x @ W``): ``ln1_scale``,
``ln1_bias`` (C), ``w_qkv`` (C, 3C), ``b_qkv`` (3C), ``w_proj`` (C, C),
``b_proj`` (C), ``ln2_scale``, ``ln2_bias`` (C).

- ``na_block_reference``: the composition in the parameters' type (fp32),
  built on ``ops/natten.py::na2d``, so that on a CUDA tensor it runs the NA
  kernels #1 (forward) and #3 (backward). It is also the backward path.
- ``na_block_plain``: the arithmetic of the TPU kernel ``_na_block_kernel``,
  step by step, bf16 matmul operands and all. It is the CPU path and the
  oracle of the CUDA kernel in ``na_block_cuda.py``.
- ``na_block``: the counterpart of ``na_block_pallas``, with its dispatch.
- ``fused_na_block``: the counterpart of the JAX ``custom_vjp``: forward
  ``na_block``, backward autograd of ``na_block_reference`` recomputed from
  the saved inputs.
"""

import typing as T

import torch

from .flags import cuda_na_block_enabled
from .natten import _clamped_shift, check_spatial, na2d

Tensor = torch.Tensor

LN_EPS = 1e-6  # natten_pallas.py::LN_EPS (the model's LayerNorms use 1e-5)
PARAM_KEYS = (
    "ln1_scale",
    "ln1_bias",
    "w_qkv",
    "b_qkv",
    "w_proj",
    "b_proj",
    "ln2_scale",
    "ln2_bias",
)


def layer_norm(x: Tensor, scale: Tensor, bias: Tensor) -> Tensor:
    """LayerNorm over the last axis with eps 1e-6 and the biased variance,
    as ``natten_pallas._layer_norm``."""
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + LN_EPS) * scale + bias


def check_block(x: Tensor, params: T.Mapping[str, Tensor], num_heads: int):
    """Raise unless ``x`` is (B, H, W, C) with ``num_heads`` dividing C and
    ``params`` holds exactly the block's eight arrays in their shapes."""
    if x.dim() != 4:
        raise ValueError(f"na_block: x must be (B, H, W, C), got {x.shape}")
    channels = x.shape[-1]
    if num_heads < 1 or channels % num_heads:
        raise ValueError(
            f"na_block: {num_heads} heads do not divide {channels} channels"
        )
    if set(params) != set(PARAM_KEYS):
        raise ValueError(
            f"na_block: params must hold {sorted(PARAM_KEYS)}, got "
            f"{sorted(params)}"
        )
    shapes = {
        "w_qkv": (channels, 3 * channels),
        "b_qkv": (3 * channels,),
        "w_proj": (channels, channels),
    }
    for key in PARAM_KEYS:
        want = shapes.get(key, (channels,))
        if tuple(params[key].shape) != want:
            raise ValueError(
                f"na_block: {key} must be {want}, got "
                f"{tuple(params[key].shape)}"
            )


def na_block_reference(
    x: Tensor,
    params: T.Mapping[str, Tensor],
    num_heads: int,
    kernel_size: int,
    dilation: int = 1,
) -> Tensor:
    """LN -> QKV -> NA -> proj -> LN in the promoted type of ``x`` and the
    parameters (fp32 for fp32 parameters, as JAX promotes bf16 with fp32),
    returned in that type."""
    dtype = torch.promote_types(x.dtype, params["w_qkv"].dtype)
    p = {key: value.to(dtype) for key, value in params.items()}
    h = layer_norm(x.to(dtype), p["ln1_scale"], p["ln1_bias"])
    qkv = h @ p["w_qkv"] + p["b_qkv"]
    q, k, v = (t.unflatten(-1, (num_heads, -1)) for t in qkv.chunk(3, -1))
    out = na2d(q, k, v, kernel_size, dilation).flatten(-2)
    out = out @ p["w_proj"] + p["b_proj"]
    return layer_norm(out, p["ln2_scale"], p["ln2_bias"])


def _bf16_matmul(a: Tensor, w: Tensor) -> Tensor:
    """bf16(a) @ bf16(w) with exact products and an fp32 sum, as the TPU's
    ``jnp.dot(..., preferred_element_type=float32)`` on bf16 operands."""
    return a.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()


def na_block_plain(
    x: Tensor,
    params: T.Mapping[str, Tensor],
    num_heads: int,
    kernel_size: int,
    dilation: int = 1,
) -> Tensor:
    """The function of the TPU kernel ``_na_block_kernel``
    (natten_pallas.py:1066-1164), on any device, in the kernel's steps:

    1. LN1 in fp32, rounded to bf16;
    2. qkv = bf16 . bf16(w_qkv) summed in fp32, + b_qkv; q scaled by
       head_dim^-0.5; k and v stay fp32;
    3. each logit is the fp32 sum over the head's channels of bf16(q_d k_d):
       the TPU rounds each product to bf16 before its head-mask matmul
       (natten_pallas.py:1118-1121), so the port does too;
    4. clamped NATTEN windows (dilated within each coset); softmax in fp32
       as exp(l - max) * (1 / sum); attn = sum of w v in fp32;
    5. proj = bf16(attn) . bf16(w_proj) summed in fp32, + b_proj;
    6. LN2 in fp32, cast to x's dtype.
    """
    check_block(x, params, num_heads)
    _, height, width, channels = x.shape
    check_spatial(height, width, kernel_size, dilation)
    f32 = {key: value.float() for key, value in params.items()}
    head_dim = channels // num_heads

    ln_x = layer_norm(x.float(), f32["ln1_scale"], f32["ln1_bias"])
    qkv = _bf16_matmul(ln_x, f32["w_qkv"]) + f32["b_qkv"]
    q, k, v = (t.unflatten(-1, (num_heads, -1)) for t in qkv.chunk(3, -1))
    q = q * head_dim**-0.5

    logits, shifted_v = [], []
    for jh in range(kernel_size):
        k_h = _clamped_shift(k, kernel_size, jh, dim=1, dilation=dilation)
        v_h = _clamped_shift(v, kernel_size, jh, dim=1, dilation=dilation)
        for jw in range(kernel_size):
            k_hw = _clamped_shift(k_h, kernel_size, jw, dim=2, dilation=dilation)
            products = (q * k_hw).to(torch.bfloat16).float()
            logits.append(products.sum(-1))
            shifted_v.append(
                _clamped_shift(v_h, kernel_size, jw, dim=2, dilation=dilation)
            )
    logits = torch.stack(logits, -1)  # (B, H, W, heads, k*k)
    exps = torch.exp(logits - logits.amax(-1, keepdim=True))
    weights = exps * (1.0 / exps.sum(-1, keepdim=True))
    attn = torch.zeros_like(v)
    for idx, v_hw in enumerate(shifted_v):
        attn = attn + weights[..., idx, None] * v_hw

    proj = _bf16_matmul(attn.flatten(-2), f32["w_proj"]) + f32["b_proj"]
    out = layer_norm(proj, f32["ln2_scale"], f32["ln2_bias"])
    return out.to(x.dtype)


def takes_reference_path(
    height: int, width: int, kernel_size: int, dilation: int
) -> bool:
    """Whether ``na_block`` computes ``na_block_reference``, as
    ``na_block_pallas`` does (natten_pallas.py:1267-1277): windows larger
    than 3 and dilated images whose sides the dilation does not divide
    (ragged cosets). That is the JAX function's own semantics, not a
    fallback after a failure."""
    ragged = dilation > 1 and (height % dilation or width % dilation)
    return kernel_size > 3 or bool(ragged)


def na_block(
    x: Tensor,
    params: T.Mapping[str, Tensor],
    num_heads: int,
    kernel_size: int,
    dilation: int = 1,
) -> Tensor:
    """The fused block's forward on whatever device ``x`` lies on, in x's
    dtype (counterpart of ``na_block_pallas``).

    ``kernel_size > 3`` and ragged dilation cosets compute
    ``na_block_reference`` (``takes_reference_path``). Every other call
    runs the hand-written kernel on a CUDA tensor (unless
    ``ops.flags.set_cuda_na_block(False)`` was called) and
    ``na_block_plain`` on a CPU tensor.
    """
    check_block(x, params, num_heads)
    _, height, width, _ = x.shape
    check_spatial(height, width, kernel_size, dilation)
    if takes_reference_path(height, width, kernel_size, dilation):
        out = na_block_reference(x, params, num_heads, kernel_size, dilation)
        return out.to(x.dtype)
    if x.device.type == "cuda" and cuda_na_block_enabled():
        from .na_block_cuda import launch_na_block_fwd

        return launch_na_block_fwd(
            x, params, num_heads, kernel_size, dilation
        )
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"na_block: unsupported device {x.device}")
    return na_block_plain(x, params, num_heads, kernel_size, dilation)


class _FusedNABlock(torch.autograd.Function):
    """Forward ``na_block``; backward autograd of ``na_block_reference``
    recomputed from the saved ``x`` and parameters (natten_pallas.py::
    _fused_bwd). On the card that backward runs NA kernels #1 and #3."""

    @staticmethod
    def forward(ctx, x, num_heads, kernel_size, dilation, *values):
        ctx.save_for_backward(x, *values)
        ctx.geometry = (num_heads, kernel_size, dilation)
        params = dict(zip(PARAM_KEYS, values))
        return na_block(x, params, num_heads, kernel_size, dilation)

    @staticmethod
    def backward(ctx, grad_out):
        x, *values = ctx.saved_tensors
        inputs = [t.detach().requires_grad_() for t in (x, *values)]
        with torch.enable_grad():
            out = na_block_reference(
                inputs[0], dict(zip(PARAM_KEYS, inputs[1:])), *ctx.geometry
            ).to(grad_out.dtype)
            grads = torch.autograd.grad(out, inputs, grad_out)
        return (grads[0], None, None, None, *grads[1:])


def fused_na_block(
    x: Tensor,
    params: T.Mapping[str, Tensor],
    num_heads: int,
    kernel_size: int,
    dilation: int = 1,
) -> Tensor:
    """Differentiable fused block (counterpart of the JAX
    ``fused_na_block``): gradients for ``x`` and every parameter."""
    check_block(x, params, num_heads)
    values = [params[key] for key in PARAM_KEYS]
    return _FusedNABlock.apply(x, num_heads, kernel_size, dilation, *values)
