"""The hand-written Hopper kernels for temporal attention.

``csrc/temporal_fwd.cu`` (``temporal_fwd``) replaces the TPU kernel
``cultionet_tpu/ops/temporal_pallas.py::_fwd_kernel`` and
``csrc/temporal_bwd.cu`` (``temporal_bwd``) replaces ``_bwd_kernel``. Their
plain PyTorch version is ``ops/temporal.py::temporal_attention_reference``
and its autograd. ``ops/build.py`` builds them at first use.

``LAUNCHES`` counts each kernel's launches, one per wrapper call, so a run
can show that its path went through the kernels.
"""

import ctypes
import typing as T

import torch

from . import build
from .temporal import check_heads

Tensor = torch.Tensor

LAUNCHES: T.Dict[str, int] = {"temporal_fwd": 0, "temporal_bwd": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PTR, _INT, _LONG = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
_DIMS = [_LONG, _INT, _INT, _INT, _INT, _INT]  # N, Tq, S, heads, hd, vec
build.register(
    build.Library(
        name="temporal_fwd",
        source="temporal_fwd.cu",
        headers=("temporal_common.cuh", "na2d_common.cuh"),
        signatures={
            "temporal_fwd": [_INT, _PTR, _PTR, _PTR, _PTR, _STRIDES, *_DIMS,
                             _PTR],
        },
        error_string="temporal_error_string",
    )
)
build.register(
    build.Library(
        name="temporal_bwd",
        source="temporal_bwd.cu",
        headers=("temporal_common.cuh", "na2d_common.cuh"),
        signatures={
            "temporal_bwd": [
                _INT, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _STRIDES,
                *_DIMS, _PTR,
            ],
        },
        error_string="temporal_error_string",
    )
)


def _check_inputs(
    q: Tensor, k: Tensor, v: Tensor, num_heads: int, g: T.Optional[Tensor]
) -> int:
    """Raises unless the kernels take these tensors; returns head_dim. The
    kernels' own limits (head_dim, the backward's shared memory) are checked
    where they launch, and a refused launch raises too."""
    named = [("q", q), ("k", k), ("v", v)]
    if g is not None:
        named.append(("g", g))
    for name, t in named:
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(
                f"temporal_cuda: {name} must lie on q's CUDA device, got "
                f"{t.device}"
            )
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise TypeError(
                f"temporal_cuda: {name} has dtype {t.dtype}; q, k, v (and g) "
                f"must share one of {sorted(map(str, _DTYPES))}"
            )
        if t.dim() != 3:
            raise ValueError(
                f"temporal_cuda: {name} must be (N, steps, C), got "
                f"{tuple(t.shape)}"
            )
        if t.stride(-1) != 1:
            raise ValueError(
                f"temporal_cuda: {name} must be unit-stride along C"
            )
    n, tq, c = q.shape
    if k.shape != v.shape or k.shape[0] != n or k.shape[2] != c:
        raise ValueError(
            f"temporal_cuda: k {tuple(k.shape)} and v {tuple(v.shape)} must "
            f"be (N, S, C) with q's N and C {(n, c)}"
        )
    if g is not None and g.shape != q.shape:
        raise ValueError(
            f"temporal_cuda: g {tuple(g.shape)} must be shaped like q "
            f"{tuple(q.shape)}"
        )
    if tq < 1 or k.shape[1] < 1:
        raise ValueError("temporal_cuda: q and k need at least one step")
    return check_heads(c, num_heads)


def _vectorized(head_dim: int, *tensors: Tensor) -> int:
    """1 if every row of every tensor starts on a 16-byte boundary and spans
    whole 16-byte chunks (the kernels then use 16-byte loads and stores)."""
    per_chunk = 16 // tensors[0].element_size()
    aligned = head_dim % per_chunk == 0 and all(
        t.data_ptr() % 16 == 0
        and t.stride(0) % per_chunk == 0
        and t.stride(1) % per_chunk == 0
        for t in tensors
    )
    return int(aligned)


def launch_temporal_fwd(
    q: Tensor, k: Tensor, v: Tensor, num_heads: int
) -> Tensor:
    """Launch ``temporal_fwd`` on the current stream: q (N, Tq, C), k and v
    (N, S, C), any strides with C unit-stride; returns a new contiguous
    (N, Tq, C) tensor in q's dtype."""
    head_dim = _check_inputs(q, k, v, num_heads, None)
    n, tq, _ = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 6)(
        *q.stride()[:2], *k.stride()[:2], *v.stride()[:2]
    )
    build.launch(
        "temporal_fwd", "temporal_fwd", q.device,
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), strides,
        n, tq, k.shape[1], num_heads, head_dim,
        _vectorized(head_dim, q, k, v),
    )
    LAUNCHES["temporal_fwd"] += 1
    return out


def launch_temporal_bwd(
    q: Tensor, k: Tensor, v: Tensor, g: Tensor, num_heads: int
) -> T.Tuple[Tensor, Tensor, Tensor]:
    """Launch ``temporal_bwd``, the gradient of ``temporal_fwd`` at
    cotangent ``g`` (N, Tq, C); returns new contiguous ``(dq, dk, dv)`` in
    q's dtype (dq is (N, Tq, C) also where q is broadcast along N)."""
    if g.stride(-1) != 1:
        g = g.contiguous()
    head_dim = _check_inputs(q, k, v, num_heads, g)
    n, tq, _ = q.shape
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk, dv = (
        torch.empty(k.shape, dtype=q.dtype, device=q.device) for _ in range(2)
    )
    strides = (ctypes.c_longlong * 8)(
        *q.stride()[:2], *k.stride()[:2], *v.stride()[:2], *g.stride()[:2]
    )
    build.launch(
        "temporal_bwd", "temporal_bwd", q.device,
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), strides,
        n, tq, k.shape[1], num_heads, head_dim,
        _vectorized(head_dim, q, k, v, g),
    )
    LAUNCHES["temporal_bwd"] += 1
    return dq, dk, dv


class _TemporalAttention(torch.autograd.Function):
    """Counterpart of the ``custom_vjp`` of
    ``temporal_pallas.temporal_attention_pallas``: kernel forward, kernel
    backward; saves only (q, k, v)."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads):
        ctx.save_for_backward(q, k, v)
        ctx.num_heads = num_heads
        return launch_temporal_fwd(q, k, v, num_heads)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = launch_temporal_bwd(q, k, v, grad_out, ctx.num_heads)
        return dq, dk, dv, None


def temporal_attention_cuda(
    q: Tensor, k: Tensor, v: Tensor, num_heads: int
) -> Tensor:
    """Temporal attention on CUDA tensors through the hand-written kernels,
    differentiable through the backward kernel. q (N, Tq, C) may be a view
    broadcast along N (stride 0, the pooling query): its gradient reaches
    the broadcast tensor through autograd of the expand. Any failure
    raises."""
    return _TemporalAttention.apply(q, k, v, num_heads)
