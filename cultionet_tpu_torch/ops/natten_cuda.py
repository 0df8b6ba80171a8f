"""The hand-written Hopper kernels for neighborhood attention.

``csrc/na2d_fwd.cu`` replaces the TPU kernels
``cultionet_tpu/ops/natten_pallas.py::_na2d_fwd_kernel`` (``na2d_fwd``) and
``_na2d_fwd_drop_kernel`` (``na2d_fwd_drop``); ``csrc/na2d_bwd.cu`` replaces
``_na2d_bwd_kernel`` (``na2d_bwd``) and ``_na2d_bwd_drop_kernel``
(``na2d_bwd_drop``). Their plain PyTorch version is
``ops/natten.py::neighborhood_attention_2d`` (with
``dropout_keep_mask`` for the dropout pair) and its autograd.

The kernels work on tiles of one dilation coset and keep the tile's halo
in shared memory; ``_tile_plan`` picks the tile for each launch on the host
(pure Python, so the CPU tests check it) and raises when no tile fits the
card's shared memory.

Build: ``ops/build.py`` compiles each source for ``sm_90a`` with ``nvcc``
into a plain-C shared library at first use and loads it with ``ctypes``.

``LAUNCHES`` counts each kernel's launches, one per wrapper call that
launches it (the backward's two passes are one launch of ``na2d_bwd``), so
a run can show that its path went through the kernels.
"""

import ctypes
import dataclasses
import functools
import math
import typing as T

import torch

from . import build
from .natten import check_dropout_rate, check_spatial

Tensor = torch.Tensor

LAUNCHES: T.Dict[str, int] = {
    "na2d_fwd": 0,
    "na2d_fwd_drop": 0,
    "na2d_bwd": 0,
    "na2d_bwd_drop": 0,
}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PTR, _INT, _UINT, _FLOAT = (
    ctypes.c_void_p,
    ctypes.c_int,
    ctypes.c_uint,
    ctypes.c_float,
)
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
_PLAN = ctypes.POINTER(ctypes.c_int)
_DIMS = [_INT] * 7  # B, H, W, N, D, kernel_size, dilation
_DROP = [_PTR, _UINT, _FLOAT]  # seed pointer, keep threshold, 1 / (1 - p)
build.register(
    build.Library(
        name="na2d_fwd",
        source="na2d_fwd.cu",
        headers=("na2d_common.cuh",),
        signatures={
            "na2d_fwd": [
                _INT, _INT, _PTR, _PTR, _PTR, _PTR, _STRIDES, *_DIMS, _PLAN,
                _PTR,
            ],
            "na2d_fwd_drop": [
                _INT, _INT, _PTR, _PTR, _PTR, _PTR, _STRIDES, *_DIMS, _PLAN,
                *_DROP, _PTR,
            ],
        },
        error_string="na2d_error_string",
    )
)
build.register(
    build.Library(
        name="na2d_bwd",
        source="na2d_bwd.cu",
        headers=("na2d_common.cuh",),
        signatures={
            "na2d_bwd": [
                _INT, _INT, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
                _STRIDES, *_DIMS, _PLAN, _PLAN, _PTR,
            ],
            "na2d_bwd_drop": [
                _INT, _INT, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
                _STRIDES, *_DIMS, _PLAN, _PLAN, *_DROP, _PTR,
            ],
        },
        error_string="na2d_error_string",
    )
)

# Shared memory one block may use on an H100 (227 KB), and the kernels'
# constants (csrc/na2d_common.cuh): channels a lane holds, threads a block.
SMEM_BYTES = 232_448
_LANE_CHANNELS = 16
_MAX_THREADS = 512
_TILE_SIDES = (1, 2, 4, 8, 16, 32)
PASSES = ("fwd", "bwd_query", "bwd_key")


def coset_start(p: int, clen: int, ks: int) -> int:
    """First key position of query position ``p``'s window in a coset of
    ``clen`` positions (``na2d_common.cuh::coset_start``)."""
    return min(max(p - ks // 2, 0), clen - ks)


def first_query(key: int, clen: int, ks: int) -> int:
    """The first query position whose window holds key position ``key``
    (``na2d_common.cuh::first_query``)."""
    p = max(0, key - (ks - 1))
    while coset_start(p, clen, ks) + ks - 1 < key:
        p += 1
    return p


def last_query(key: int, clen: int, ks: int) -> int:
    """The last query position whose window holds ``key``."""
    p = min(clen - 1, key + ks - 1)
    while coset_start(p, clen, ks) > key:
        p -= 1
    return p


def key_halo(p0: int, p1: int, clen: int, ks: int) -> T.Tuple[int, int]:
    """First and last key position of the windows of queries [p0, p1)."""
    return coset_start(p0, clen, ks), coset_start(p1 - 1, clen, ks) + ks - 1


def query_halo(p0: int, p1: int, clen: int, ks: int) -> T.Tuple[int, int]:
    """First and last query position whose window holds a key of [p0, p1)."""
    return first_query(p0, clen, ks), last_query(p1 - 1, clen, ks)


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """One launch's tiles (``na2d_common.cuh::Plan``, field for field).

    A block owns a ``th x tw`` tile of one (batch, head, coset); each pixel
    goes to ``group`` lanes, lane ``l`` holding chunks ``l * lane_step + i *
    chunk_step`` (``i < chunks_per_lane``) of the head vector; halo pixels
    sit ``pix`` elements apart in shared memory, which holds ``cap`` of
    them; ``tiles_h x tiles_w`` tiles cover the longest coset; ``smem`` is
    the block's dynamic shared memory in bytes.
    """

    th: int
    tw: int
    group: int
    lane_step: int
    chunk_step: int
    chunks_per_lane: int
    pix: int
    cap: int
    tiles_h: int
    tiles_w: int
    smem: int

    @property
    def threads(self) -> int:
        return -(-self.th * self.tw * self.group // 32) * 32

    @functools.cached_property
    def args(self) -> ctypes.Array:
        """The fields as the kernels read them (built once: plans are
        cached and the kernels only read it)."""
        return (ctypes.c_int * 11)(*dataclasses.astuple(self))


def _lanes(head_dim: int, vec: int) -> T.Tuple[int, int, int]:
    """Chunks per pixel, lanes per pixel (a power of two) and chunks per
    lane: a lane holds at most ``_LANE_CHANNELS`` channels."""
    nchunks = head_dim // vec
    group = 1
    while group * (_LANE_CHANNELS // vec) < nchunks:
        group *= 2
    if group > 32:
        raise ValueError(
            f"na2d_cuda: head_dim {head_dim} needs more than 32 lanes of "
            f"{_LANE_CHANNELS} channels"
        )
    return nchunks, group, -(-nchunks // group)


def _bank_conflicts(nchunks, group, cpl, steps, stride) -> int:
    """Largest number of distinct 16-byte words one bank group serves in a
    quarter warp's read of neighbouring halo pixels (8 lanes, 16 bytes
    each: 8 bank groups of 4 banks)."""
    worst = 1
    for i in range(cpl):
        banks: T.Dict[int, set] = {}
        for t in range(8):
            pixel, lane = divmod(t, group)
            chunk = lane * steps[0] + i * steps[1]
            if chunk < nchunks:
                word = pixel * stride + chunk
                banks.setdefault(word % 8, set()).add(word)
        worst = max([worst, *map(len, banks.values())])
    return worst


def _layout(nchunks: int, group: int, cpl: int, vec: int):
    """(lane_step, chunk_step, pix): the chunks of each lane, contiguous or
    strided, and the pixel stride in shared memory, padded by up to 7
    chunks, whichever pair reads with the fewest bank conflicts."""
    if vec == 1:
        return 1, group, nchunks
    best = None
    for steps in ((cpl, 1), (1, group)):
        for stride in range(nchunks, nchunks + 8):
            key = (_bank_conflicts(nchunks, group, cpl, steps, stride), stride)
            if best is None or key < best[0]:
                best = (key, steps, stride)
    _, (lane_step, chunk_step), stride = best
    return lane_step, chunk_step, stride * vec


def _smem_bytes(pass_, cap, pix, itemsize, kk, pixels) -> int:
    """The kernels' dynamic shared memory: two halo tensors (k and v, or q
    and g), then fp32 rows: kk per query (forward), 2 kk per query (pass
    1), 2 kk per halo query (pass 2, its scratch rows)."""
    halo = -(-cap * pix * itemsize // 16) * 16
    rows = {"fwd": pixels * kk, "bwd_query": pixels * 2 * kk}.get(
        pass_, cap * 2 * kk
    )
    return 2 * halo + 4 * rows


@functools.lru_cache(maxsize=256)
def _tile_plan(
    height: int,
    width: int,
    kernel_size: int,
    dilation: int,
    head_dim: int,
    itemsize: int,
    pass_: str,
    vec: T.Optional[int] = None,
) -> TilePlan:
    """The tile of one launch of pass ``pass_`` (``"fwd"``, ``"bwd_query"``
    or ``"bwd_key"``).

    ``vec`` is the elements per load (16 / itemsize on the vector path, 1
    on the scalar one; by default the vector path when ``head_dim *
    itemsize`` is a multiple of 16). Among tiles of 1 to 32 positions a
    side, within 512 threads and ``SMEM_BYTES`` of shared memory, it takes
    the one with the least estimated work over the longest coset: padded
    query slots times k^2 window slots, plus twice the halo pixels loaded,
    plus a block's fixed cost. Raises if not even a 1 x 1 tile fits.
    """
    if pass_ not in PASSES:
        raise ValueError(f"_tile_plan: pass must be one of {PASSES}")
    if vec is None:
        vec = 16 // itemsize if head_dim * itemsize % 16 == 0 else 1
    nchunks, group, cpl = _lanes(head_dim, vec)
    lane_step, chunk_step, pix = _layout(nchunks, group, cpl, vec)
    kk = kernel_size * kernel_size
    clen_h, clen_w = -(-height // dilation), -(-width // dilation)
    # Forward and pass 1 read the tile's keys, pass 2 the queries of its
    # keys: the tile widened by k - 1, or by 2 (k - 1), at most.
    reach = 2 * (kernel_size - 1) if pass_ == "bwd_key" else kernel_size - 1
    best = None
    smallest = None
    for th in _TILE_SIDES:
        for tw in _TILE_SIDES:
            threads = -(-th * tw * group // 32) * 32
            if threads > _MAX_THREADS:
                continue
            cap = min(clen_h, th + reach) * min(clen_w, tw + reach)
            smem = _smem_bytes(pass_, cap, pix, itemsize, kk, threads // group)
            if smallest is None or smem < smallest:
                smallest = smem
            if smem > SMEM_BYTES:
                continue
            tiles_h, tiles_w = -(-clen_h // th), -(-clen_w // tw)
            cost = tiles_h * tiles_w * (threads // group * kk + 2 * cap + 64)
            key = (cost, -th * tw)
            if best is None or key < best[0]:
                best = (
                    key,
                    TilePlan(
                        th, tw, group, lane_step, chunk_step, cpl, pix, cap,
                        tiles_h, tiles_w, smem,
                    ),
                )
    if best is None:
        raise ValueError(
            f"na2d_cuda: {pass_} at kernel_size {kernel_size}, head_dim "
            f"{head_dim} and {itemsize}-byte elements needs {smallest} bytes "
            f"of shared memory at its smallest tile; a block has "
            f"{SMEM_BYTES}"
        )
    return best[1]


def _vector_width(head_dim: int, *tensors: Tensor) -> int:
    """16 / itemsize when every tensor's pointer and (b, h, w, head)
    strides are 16-byte aligned and a head vector is whole 16-byte chunks;
    else 1 (the kernels' scalar path)."""
    vec = 16 // tensors[0].element_size()
    if head_dim % vec:
        return 1
    for t in tensors:
        if t.data_ptr() % 16:
            return 1
        for stride, size in zip(t.stride()[:4], t.shape[:4]):
            if stride % vec and size > 1:
                return 1
    return vec


def _check_inputs(q: Tensor, *others: T.Tuple[str, Tensor]) -> None:
    for name, t in (("q", q), *others):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(
                f"na2d_cuda: {name} must lie on q's CUDA device, got "
                f"{t.device}"
            )
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise TypeError(
                f"na2d_cuda: {name} has dtype {t.dtype}; q, k, v (and g) "
                f"must share one of {sorted(map(str, _DTYPES))}"
            )
        if t.dim() != 5 or t.shape != q.shape:
            raise ValueError(
                f"na2d_cuda: {name} must be (B, H, W, heads, head_dim) like "
                f"q {tuple(q.shape)}, got {tuple(t.shape)}"
            )
        if t.stride(-1) != 1:
            raise ValueError(
                f"na2d_cuda: {name} must be unit-stride along head_dim"
            )


def _variant(
    name: str, attn_drop: float, seed: T.Optional[Tensor], device
) -> T.Tuple[str, list]:
    """The kernel to launch (``name`` or its dropout variant, chosen by
    whether a seed is given) and the dropout variant's extra arguments:
    seed pointer, keep threshold ceil(p * 2^24) and 1 / (1 - p)."""
    check_dropout_rate(attn_drop)
    if seed is None:
        if attn_drop > 0:
            raise ValueError(f"{name}: attention dropout needs a seed")
        return name, []
    if seed.dtype != torch.int32 or seed.numel() != 1 or seed.device != device:
        raise ValueError(
            f"{name}: the seed must be a one-element int32 tensor on {device}"
        )
    threshold = math.ceil(attn_drop * (1 << 24))
    inv_keep = 1.0 / (1.0 - attn_drop)
    return f"{name}_drop", [seed.data_ptr(), threshold, inv_keep]


def launch_na2d_fwd(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    kernel_size: int,
    dilation: int,
    attn_drop: float = 0.0,
    seed: T.Optional[Tensor] = None,
) -> Tensor:
    """Launch ``na2d_fwd``, or ``na2d_fwd_drop`` when a ``seed`` is given
    (at ``attn_drop = 0`` it equals ``na2d_fwd``), on the current stream;
    returns a new contiguous ``(B, H, W, heads, head_dim)`` tensor in q's
    dtype."""
    _check_inputs(q, ("k", k), ("v", v))
    batch, height, width, heads, head_dim = q.shape
    check_spatial(height, width, kernel_size, dilation)
    fn, drop = _variant("na2d_fwd", attn_drop, seed, q.device)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    vec = _vector_width(head_dim, q, k, v, out)
    plan = _tile_plan(
        height, width, kernel_size, dilation, head_dim, q.element_size(),
        "fwd", vec,
    )
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:4], *k.stride()[:4], *v.stride()[:4]
    )
    build.launch(
        "na2d_fwd", fn, q.device,
        _DTYPES[q.dtype], vec, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), strides,
        batch, height, width, heads, head_dim, kernel_size, dilation,
        plan.args, *drop,
    )
    LAUNCHES[fn] += 1
    return out


def launch_na2d_bwd(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    g: Tensor,
    kernel_size: int,
    dilation: int,
    attn_drop: float = 0.0,
    seed: T.Optional[Tensor] = None,
) -> T.Tuple[Tensor, Tensor, Tensor]:
    """Launch ``na2d_bwd``, or ``na2d_bwd_drop`` when a ``seed`` is given,
    the gradient of the matching forward at cotangent ``g``; returns new
    contiguous ``(dq, dk, dv)`` in q's dtype."""
    if g.stride(-1) != 1:
        g = g.contiguous()
    _check_inputs(q, ("k", k), ("v", v), ("g", g))
    batch, height, width, heads, head_dim = q.shape
    check_spatial(height, width, kernel_size, dilation)
    fn, drop = _variant("na2d_bwd", attn_drop, seed, q.device)
    dq, dk, dv = (
        torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(3)
    )
    # Per query-head and window slot: ds_j, then the dropped weight w~_j.
    scratch = torch.empty(
        (batch * height * width * heads, 2 * kernel_size * kernel_size),
        dtype=torch.float32, device=q.device,
    )
    vec = _vector_width(head_dim, q, k, v, g, dq)
    geometry = (
        height, width, kernel_size, dilation, head_dim, q.element_size()
    )
    plans = [_tile_plan(*geometry, p, vec) for p in ("bwd_query", "bwd_key")]
    strides = (ctypes.c_longlong * 16)(
        *q.stride()[:4], *k.stride()[:4], *v.stride()[:4], *g.stride()[:4]
    )
    build.launch(
        "na2d_bwd", fn, q.device,
        _DTYPES[q.dtype], vec, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        scratch.data_ptr(), strides,
        batch, height, width, heads, head_dim, kernel_size, dilation,
        *(p.args for p in plans), *drop,
    )
    LAUNCHES[fn] += 1
    return dq, dk, dv


class _NA2d(torch.autograd.Function):
    """Counterpart of ``natten_pallas.na2d_fused``: kernel forward, kernel
    backward; saves only (q, k, v)."""

    @staticmethod
    def forward(ctx, q, k, v, kernel_size, dilation):
        ctx.save_for_backward(q, k, v)
        ctx.geometry = (kernel_size, dilation)
        return launch_na2d_fwd(q, k, v, kernel_size, dilation)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = launch_na2d_bwd(q, k, v, grad_out, *ctx.geometry)
        return dq, dk, dv, None, None


class _NA2dDropout(torch.autograd.Function):
    """Counterpart of ``natten_pallas.na2d_fused_dropout``: saves (q, k, v)
    and the seed; the backward redraws the forward's mask from the seed, so
    nothing mask-sized is stored."""

    @staticmethod
    def forward(ctx, q, k, v, seed, kernel_size, dilation, attn_drop):
        ctx.save_for_backward(q, k, v, seed)
        ctx.geometry = (kernel_size, dilation, attn_drop)
        return launch_na2d_fwd(
            q, k, v, kernel_size, dilation, attn_drop=attn_drop, seed=seed
        )

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, seed = ctx.saved_tensors
        kernel_size, dilation, attn_drop = ctx.geometry
        dq, dk, dv = launch_na2d_bwd(
            q, k, v, grad_out, kernel_size, dilation,
            attn_drop=attn_drop, seed=seed,
        )
        return dq, dk, dv, None, None, None, None


def na2d_cuda(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    kernel_size: int,
    dilation: int = 1,
    attn_drop: float = 0.0,
    seed: T.Optional[Tensor] = None,
) -> Tensor:
    """Neighborhood attention on CUDA tensors through the hand-written
    kernels, differentiable through the backward kernels.

    ``attn_drop > 0`` applies inverted dropout to the attention weights
    with the keep bits of ``seed`` (a one-element int32 tensor on q's
    device; ``ops/natten.py::dropout_keep_mask``). ``kernel_size == 1``
    returns ``v`` (a one-key softmax is 1), without dropout, as the Pallas
    path does. Every other shape with ``min(H, W) >= kernel_size *
    dilation`` runs the kernels; any failure raises.
    """
    check_spatial(q.shape[1], q.shape[2], kernel_size, dilation)
    if kernel_size == 1:
        return v
    if attn_drop > 0:
        return _NA2dDropout.apply(
            q, k, v, seed, kernel_size, dilation, float(attn_drop)
        )
    return _NA2d.apply(q, k, v, kernel_size, dilation)
