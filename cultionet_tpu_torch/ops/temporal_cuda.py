"""The hand-written Hopper kernels for temporal attention.

``csrc/temporal_fwd.cu`` (``temporal_fwd``) replaces the TPU kernel
``cultionet_tpu/ops/temporal_pallas.py::_fwd_kernel`` and
``csrc/temporal_bwd.cu`` (``temporal_bwd``) replaces ``_bwd_kernel``. Their
plain PyTorch version is ``ops/temporal.py::temporal_attention_reference``
and its autograd. ``ops/build.py`` builds them at first use.

The kernels walk tiles of whole pixels held in shared memory;
``_tile_plan`` lays out each launch's tiles on the host (pure Python, so the
CPU tests check it) and raises when not even one pixel fits a block.

``LAUNCHES`` counts each kernel's launches, one per wrapper call, so a run
can show that its path went through the kernels.
"""

import ctypes
import dataclasses
import functools
import typing as T

import torch

from . import build
from .temporal import check_heads

Tensor = torch.Tensor

LAUNCHES: T.Dict[str, int] = {"temporal_fwd": 0, "temporal_bwd": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PTR, _INT, _LONG = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
_PLAN = ctypes.POINTER(ctypes.c_int)
# N, Tq, S, heads, hd, vec, plan
_DIMS = [_LONG, _INT, _INT, _INT, _INT, _INT, _PLAN]
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


# Shared memory one block may use on an H100 (227 KB) and that an SM holds
# (228 KB, 1 KB of it reserved per block); the kernels' constants
# (csrc/temporal_common.cuh): threads a block, steps per MMA chunk, the
# bf16 row stride of a warp's 16 x 16 scratch.
SMEM_BYTES = 232_448
_SM_BYTES = 233_472
_THREADS = 256
_WARPS = _THREADS // 32
_CHUNK = 16
_SCRATCH_ROW = 24
# Items a tile should give: a warp-item per (pixel, head) on the tensor-core
# path, a warp-item per pixel on the pooling path, a thread-item per (pixel,
# step, head) on the SIMT path (fp32).
_MMA_ITEMS = 2 * _WARPS
_POOL_ITEMS = _WARPS
_SIMT_ITEMS = _THREADS


def _a16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def _row_stride(elems: int, itemsize: int) -> int:
    """Elements between two rows in shared memory: whole 16-byte chunks, an
    odd number of them, so the 8 rows of an MMA fragment (or of a
    quarter warp's 16-byte reads) fall in distinct banks."""
    chunks = -(-elems * itemsize // 16)
    chunks += 1 - chunks % 2
    return chunks * 16 // itemsize


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """One launch's tiles (``temporal_common.cuh::Plan``, field for field).

    A block walks tiles ``blockIdx.x, blockIdx.x + grid, ...`` of
    ``pixels`` whole pixels (``tiles`` cover N). Shared memory, in bytes:
    the broadcast pooling query before ``stage0``; ``stages`` input stages
    of ``stage_bytes``, ``pix_bytes`` a pixel, with q, k, v and g rows at
    ``q_off``, ``k_off``, ``v_off``, ``g_off`` (``fused``: q, k, v as the
    thirds of one (T, 3C) row); the staged outputs from ``out0``,
    ``out_pix_bytes`` a pixel (out; or the fp32 dq, then dk, dv and the
    per-row softmax statistics); from ``scratch0`` ``scratch_warp`` bytes
    for each warp. Row strides ``rs_*`` are elements. On the tensor-core
    paths (``mma``; ``pool``, the pooling call with a warp per pixel) q and
    g hold ``tq_rows`` rows and k and v ``s_rows``, the steps rounded up to
    16, the rows past them zero; the pooling path's query fragments sit at
    ``qfrag_off``.
    """

    pixels: int
    stages: int
    grid: int
    tiles: int
    smem: int
    mma: int
    fused: int
    q_bcast: int
    rs_q: int
    rs_kv: int
    rs_g: int
    rs_out: int
    rs_dq: int
    pix_bytes: int
    stage0: int
    stage_bytes: int
    q_off: int
    k_off: int
    v_off: int
    g_off: int
    out0: int
    out_pix_bytes: int
    dk_off: int
    dv_off: int
    stats_off: int
    scratch0: int
    pool: int
    tq_rows: int
    s_rows: int
    qfrag_off: int
    scratch_warp: int
    # Not passed to the kernels:
    blocks_per_sm: int
    t_pad: int  # steps the MMA chunks span (Tq and S rounded up to 16)
    hd_pad: int  # the kernels' register width for head_dim

    @functools.cached_property
    def args(self) -> ctypes.Array:
        """The kernels' fields (built once: plans are cached)."""
        fields = dataclasses.astuple(self)[:31]
        return (ctypes.c_int * len(fields))(*fields)


def _layout(
    pixels, stages, tq, s, channels, heads, itemsize, backward, mma, pool,
    fused, q_bcast,
) -> T.Dict[str, int]:
    """Byte offsets, row strides and padded row counts of a tile of
    ``pixels`` pixels."""
    pad = lambda rows: -(-rows // _CHUNK) * _CHUNK if mma else rows  # noqa
    tq_rows, s_rows = (tq if pool else pad(tq)), pad(s)
    rs_c = _row_stride(channels, itemsize)
    rs_kv = _row_stride(3 * channels, itemsize) if fused else rs_c
    rs_q = rs_kv if fused else rs_c
    lay = dict(
        rs_q=rs_q, rs_kv=rs_kv, rs_g=rs_c, rs_out=rs_c, rs_dq=0,
        tq_rows=tq_rows, s_rows=s_rows,
    )
    if fused:
        lay.update(q_off=0, k_off=channels * itemsize,
                   v_off=2 * channels * itemsize)
        off = _a16(s_rows * rs_kv * itemsize)
    else:
        off = 0 if q_bcast else _a16(tq_rows * rs_q * itemsize)
        kv = _a16(s_rows * rs_kv * itemsize)
        lay.update(q_off=0, k_off=off, v_off=off + kv)
        off += 2 * kv
    lay["g_off"] = off
    if backward:
        off += _a16(tq_rows * rs_c * itemsize)
    lay["pix_bytes"] = off
    const = _a16(tq_rows * rs_q * itemsize) if q_bcast else 0
    lay["qfrag_off"] = const
    if pool:
        const += channels // 16 * 32 * 8
    lay["stage0"] = const
    lay["stage_bytes"] = pixels * lay["pix_bytes"]
    lay["out0"] = lay["stage0"] + stages * lay["stage_bytes"]
    if backward and pool:
        # dk and dv leave from registers; no statistics.
        lay["rs_dq"] = _row_stride(channels, 4)
        lay.update(dk_off=0, dv_off=0, stats_off=0)
        lay["out_pix_bytes"] = _a16(tq * lay["rs_dq"] * 4)
    elif backward:
        lay["rs_dq"] = _row_stride(channels, 4)
        lay["dk_off"] = _a16(tq * lay["rs_dq"] * 4)
        lay["dv_off"] = lay["dk_off"] + _a16(s * rs_c * itemsize)
        lay["stats_off"] = lay["dv_off"] + _a16(s * rs_c * itemsize)
        lay["out_pix_bytes"] = lay["stats_off"] + _a16(tq * heads * 12)
    else:
        lay.update(dk_off=0, dv_off=0, stats_off=0)
        lay["out_pix_bytes"] = _a16(tq * rs_c * itemsize)
    lay["scratch0"] = lay["out0"] + pixels * lay["out_pix_bytes"]
    if pool:
        # dS^T in bf16 (16 x 8), then P and dS in fp32; the forward: P^T.
        lay["scratch_warp"] = 256 + 1024 if backward else 256
    elif mma and backward:
        lay["scratch_warp"] = 2 * _CHUNK * _SCRATCH_ROW * 2  # P^T, dS^T
    else:
        lay["scratch_warp"] = 0
    lay["smem"] = lay["scratch0"] + _WARPS * lay["scratch_warp"]
    return lay


def _register_width(head_dim: int, mma: bool) -> int:
    for width in (8, 16, 32, 64, 128):
        if head_dim <= width and (width >= 16 or not mma):
            return width
    raise ValueError(f"temporal_cuda: head_dim {head_dim} is above 128")


@functools.lru_cache(maxsize=256)
def _tile_plan(
    n: int,
    tq: int,
    s: int,
    channels: int,
    heads: int,
    itemsize: int,
    backward: bool,
    fused: bool = False,
    q_bcast: bool = False,
    sms: int = 132,
) -> TilePlan:
    """The tiles of one launch of ``temporal_fwd`` (or ``temporal_bwd``
    when ``backward``) over ``n`` pixels of ``tq`` query and ``s`` key
    steps.

    bf16 runs on the tensor cores (``mma``; the pooling call with a query
    broadcast over the pixels on its own path, a warp per pixel), fp32 on
    the SIMT path. A tile holds enough pixels for ``_MMA_ITEMS`` or
    ``_POOL_ITEMS`` warp-items, or ``_SIMT_ITEMS`` thread-items.
    Two copy stages where they fit ``SMEM_BYTES``, else one, halving the
    tile until it fits; the grid is persistent, as many blocks as fit the
    card's ``sms`` SMs at once, at most one per tile. Raises if not even a
    one-pixel tile fits.
    """
    head_dim = check_heads(channels, heads)
    mma = itemsize == 2
    if fused and (q_bcast or tq != s):
        raise ValueError("temporal_cuda: fused q, k, v need Tq == S")
    # The pooling path: one query row shared by every pixel, at most 16 key
    # steps and 8 heads (one MMA tile each), whole 16-channel steps.
    pool = mma and q_bcast and tq == 1 and s <= _CHUNK and heads <= 8
    pool = pool and channels % 16 == 0
    hd_pad = _register_width(head_dim, mma)
    if pool:
        pixels = _POOL_ITEMS
    else:
        per_pixel = heads if mma else heads * min(tq, s)
        pixels = -(-(_MMA_ITEMS if mma else _SIMT_ITEMS) // per_pixel)
    geometry = (tq, s, channels, heads, itemsize, backward, mma, pool, fused,
                q_bcast)
    smallest = None
    for stages in (2, 1):
        p = max(1, min(pixels, n))
        while True:
            lay = _layout(p, stages, *geometry)
            smallest = min(smallest or lay["smem"], lay["smem"])
            if lay["smem"] <= SMEM_BYTES:
                tiles = -(-n // p)
                per_sm = min(
                    2048 // _THREADS, _SM_BYTES // (lay["smem"] + 1024)
                )
                return TilePlan(
                    pixels=p, stages=stages,
                    grid=max(1, min(tiles, sms * per_sm)), tiles=tiles,
                    mma=int(mma), fused=int(fused), q_bcast=int(q_bcast),
                    pool=int(pool), blocks_per_sm=per_sm,
                    t_pad=-(-max(tq, s) // 16) * 16, hd_pad=hd_pad, **lay,
                )
            if p == 1:
                break
            p = (p + 1) // 2
    raise ValueError(
        f"temporal_cuda: a one-pixel tile of {tq} query and {s} key steps "
        f"at C = {channels} needs {smallest} bytes of shared memory; a block "
        f"has {SMEM_BYTES}"
    )


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _vectorized(channels: int, *tensors: Tensor) -> int:
    """1 if every row of every tensor starts on a 16-byte boundary and spans
    whole 16-byte chunks (the kernels then copy rows in 16-byte chunks)."""
    per_chunk = 16 // tensors[0].element_size()
    aligned = channels % per_chunk == 0 and all(
        t.data_ptr() % 16 == 0
        and t.stride(0) % per_chunk == 0
        and t.stride(1) % per_chunk == 0
        for t in tensors
    )
    return int(aligned)


def _fused(q: Tensor, k: Tensor, v: Tensor) -> bool:
    """q, k and v are the thirds of one (N, T, 3C) projection, in order:
    the kernels then copy each pixel's rows as one range."""
    step = q.shape[2] * q.element_size()
    return (
        q.shape[1] == k.shape[1]
        and q.stride(0) != 0
        and q.stride() == k.stride() == v.stride()
        and k.data_ptr() == q.data_ptr() + step
        and v.data_ptr() == k.data_ptr() + step
    )


def _plan_for(
    q: Tensor, k: Tensor, v: Tensor, num_heads: int, backward: bool
) -> TilePlan:
    n, tq, c = q.shape
    return _tile_plan(
        n, tq, k.shape[1], c, num_heads, q.element_size(), backward,
        fused=_fused(q, k, v),
        q_bcast=q.stride(0) == 0,
        sms=_sm_count(q.device),
    )


def launch_temporal_fwd(
    q: Tensor, k: Tensor, v: Tensor, num_heads: int
) -> Tensor:
    """Launch ``temporal_fwd`` on the current stream: q (N, Tq, C), k and v
    (N, S, C), any strides with C unit-stride; returns a new contiguous
    (N, Tq, C) tensor in q's dtype."""
    head_dim = _check_inputs(q, k, v, num_heads, None)
    n, tq, c = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    plan = _plan_for(q, k, v, num_heads, False)
    strides = (ctypes.c_longlong * 6)(
        *q.stride()[:2], *k.stride()[:2], *v.stride()[:2]
    )
    build.launch(
        "temporal_fwd", "temporal_fwd", q.device,
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), strides,
        n, tq, k.shape[1], num_heads, head_dim,
        _vectorized(c, q, k, v), plan.args,
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
    n, tq, c = q.shape
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk, dv = (
        torch.empty(k.shape, dtype=q.dtype, device=q.device) for _ in range(2)
    )
    plan = _plan_for(q, k, v, num_heads, True)
    strides = (ctypes.c_longlong * 8)(
        *q.stride()[:2], *k.stride()[:2], *v.stride()[:2], *g.stride()[:2]
    )
    build.launch(
        "temporal_bwd", "temporal_bwd", q.device,
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), strides,
        n, tq, k.shape[1], num_heads, head_dim,
        _vectorized(c, q, k, v, g), plan.args,
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
