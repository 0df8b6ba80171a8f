"""The hand-written Hopper kernel of the fused NA block.

``csrc/na_block_fwd.cu`` replaces the TPU kernel
``cultionet_tpu/ops/natten_pallas.py::_na_block_kernel``; its plain PyTorch
version is ``ops/na_block.py::na_block_plain``. Build: ``ops/build.py``
compiles it for ``sm_90a`` with ``nvcc`` at first use.

The kernel is one launch over tiles of one (batch, dilation coset): a block
normalizes the tile's key rectangle into shared memory and computes q, k
and v there, head group by head group, so nothing but x and the output
crosses device memory. ``_tile_plan`` picks the tile for each launch on the
host (pure Python, so the CPU tests check it) and ``prepare_weights`` lays
the parameters out as the kernel reads them. ``launch_prepared`` launches on
prepared weights; ``launch_na_block_fwd`` prepares and launches.

``LAUNCHES["na_block_fwd"]`` counts the kernel's launches (one per call).
"""

import ctypes
import dataclasses
import functools
import typing as T

import torch

from . import build
from .na_block import LN_EPS, check_block
from .natten import check_spatial

Tensor = torch.Tensor

LAUNCHES: T.Dict[str, int] = {"na_block_fwd": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
build.register(
    build.Library(
        name="na_block_fwd",
        source="na_block_fwd.cu",
        headers=("na2d_common.cuh", "temporal_common.cuh"),
        signatures={
            # dtype, vec, x, 8 parameters, out,
            # B, H, W, C, heads, kernel_size, dilation, plan, eps, stream
            "na_block_fwd": [
                _INT, _INT, *[_PTR] * 10, *[_INT] * 7,
                ctypes.POINTER(ctypes.c_int), _FLOAT, _PTR,
            ],
        },
        error_string="na_block_error_string",
    )
)

# The card and the kernel's constants (csrc/na_block_fwd.cu): shared memory
# a block may use on an H100 (227 KB), of which the kernel's static tables
# (rectangle rows, ring barriers) may take 1 KB; its SMs; the products' sweeps of 192
# (QKV) and 256 (projection) columns and their weight ring (3 stages of 32
# rows of the projection's sweep); the channels C may reach.
SMEM_BYTES = 232_448
_STATIC_SMEM = 1024
SMS = 132
_WIDTH_QKV, _WIDTH_PROJ = 192, 256
_RING_BYTES = 3 * 32 * (_WIDTH_PROJ + 8) * 2
_MAX_CHANNELS = 512
_THREADS = 512
_TILE_SIDES = (1, 2, 4, 8, 16)
_PASS_COLUMNS = 64  # heads share a pass up to this many channels


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def padded_channels(channels: int) -> int:
    """The kernel's channel count: C rounded up to the MMA depth 16."""
    return _ceil(channels, 16) * 16


def head_layout(channels: int, heads: int) -> T.Tuple[int, int, int]:
    """(dp, group, passes): head_dim rounded up to 16, the heads of one
    pass (the largest divisor of ``heads`` whose padded channels fit in 64,
    or 1) and the number of passes."""
    dp = _ceil(channels // heads, 16) * 16
    group = max(
        g for g in range(1, heads + 1)
        if heads % g == 0 and (g == 1 or g * dp <= _PASS_COLUMNS)
    )
    return dp, group, heads // group


def _rows_covered(rows: int, choices: T.Tuple[int, ...]) -> T.Optional[int]:
    """The rows a product's two warp rows cover: the least of ``choices``
    that holds ``rows``."""
    return next((c for c in choices if rows <= c), None)


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """One launch's tiles (``na_block_fwd.cu::Plan``, field for field).

    A block owns a ``th x tw`` tile of positions of one (batch, coset),
    ``tiles_h x tiles_w`` tiles covering the longest coset. Its key
    rectangle holds at most ``cap`` pixels; the QKV product covers
    ``rows_pad`` rows (a multiple of 16 from 32 to 128) and the projection
    ``tile_pad`` (32 or 64). Heads are padded to ``dp`` channels and go
    ``group`` at a time through ``passes`` passes of ``p = group * dp``
    channels; ``lanes`` lanes take one (query, head) in the attention. ``ld_*`` are row
    strides in elements, ``off_*`` byte offsets into the block's ``smem``
    bytes of dynamic shared memory.
    """

    th: int
    tw: int
    tiles_h: int
    tiles_w: int
    cap: int
    rows_pad: int
    tile_pad: int
    dp: int
    group: int
    passes: int
    p: int
    lanes: int
    ld_ln: int
    ld_attn: int
    ld_kv: int
    ld_proj: int
    off_attn: int
    off_ln: int
    off_k: int
    off_v: int
    off_q: int
    off_x: int
    off_proj: int
    smem: int

    @functools.cached_property
    def args(self) -> ctypes.Array:
        """The fields as the kernel reads them (built once: plans are
        cached and the kernel only reads it)."""
        values = dataclasses.astuple(self)
        return (ctypes.c_int * len(values))(*values)


def _align16(nbytes: int) -> int:
    return _ceil(nbytes, 16) * 16


def _layout(th, tw, cap, rows_pad, tile_pad, channels, heads, itemsize):
    """The shared-memory layout of a ``th x tw`` tile whose key rectangle
    holds ``cap`` pixels: the weight ring, then the bf16 attention rows
    (live to the projection), the bf16 LN1 rows, then per pass k, v
    (``cap`` rows) and q (the tile's rows) in fp32. x's staging overlaps
    k, v and q (it dies before the first pass) and the fp32 projection
    overlaps LN1, k, v and q (they die before it)."""
    cp = padded_channels(channels)
    dp, group, passes = head_layout(channels, heads)
    p = group * dp
    # Lanes a (query, head) item: enough to give the block's 512 threads an
    # item each where the head allows, at least 4 and at most 4 chunks of 4
    # channels a lane.
    lanes = 1
    while lanes * 2 * th * tw * group <= _THREADS:
        lanes *= 2
    lanes = min(dp // 4, 32, max(4, dp // 16, lanes))
    # With 4 lanes two items share a quarter warp: rows 16 floats past a
    # multiple of 32 put their neighbouring k and v rows in disjoint banks.
    ld_kv = p + (16 - p % 32) % 32 if lanes == 4 else p + 4
    ld_ln, ld_attn, ld_proj = cp + 8, heads * dp + 8, cp + 4
    off_attn = _RING_BYTES
    off_ln = off_attn + _align16(tile_pad * ld_attn * 2)
    off_k = off_ln + _align16(rows_pad * ld_ln * 2)
    off_v = off_k + _align16(cap * ld_kv * 4)
    off_q = off_v + _align16(cap * ld_kv * 4)
    end = max(
        off_q + _align16(th * tw * ld_kv * 4),
        off_k + _align16(cap * channels * itemsize),
        off_ln + _align16(tile_pad * ld_proj * 4),
    )
    return dict(
        dp=dp, group=group, passes=passes, p=p, lanes=lanes, ld_ln=ld_ln,
        ld_attn=ld_attn, ld_kv=ld_kv, ld_proj=ld_proj, off_attn=off_attn,
        off_ln=off_ln, off_k=off_k, off_v=off_v, off_q=off_q, off_x=off_k,
        off_proj=off_ln, smem=end,
    )


def _block_clocks(th, tw, rows_pad, tile_pad, layout, channels, heads, ks):
    """A block's estimated SM clocks: the two products at 1,024 bf16 MACs
    a clock (``mma.sync``) over the rows and columns their warp tiles
    cover, the attention's window at 7 lane instructions a channel over
    128 lanes a clock, and a fixed cost a pass (its barriers and copies)."""
    cp, cols = padded_channels(channels), heads * layout["dp"]
    qkv = rows_pad * cp * _ceil(3 * layout["p"], _WIDTH_QKV) * _WIDTH_QKV
    proj = tile_pad * cols * _ceil(cp, _WIDTH_PROJ) * _WIDTH_PROJ
    macs = layout["passes"] * qkv + proj
    attention = th * tw * cols * ks * ks * 7 / 128
    return macs / 1024 + attention + 3000 * (layout["passes"] + 2)


def _plan_for(
    th, tw, height, width, kernel_size, dilation, channels, heads, itemsize
) -> T.Optional[TilePlan]:
    """The plan of a ``th x tw`` tile, or None where its key rectangle
    passes 128 rows, the tile 64, or its shared memory ``SMEM_BYTES``
    beside the kernel's static tables."""
    clen_h, clen_w = _ceil(height, dilation), _ceil(width, dilation)
    cap = min(clen_h, th + kernel_size - 1) * min(clen_w, tw + kernel_size - 1)
    rows_pad = _rows_covered(cap, tuple(range(32, 129, 16)))
    tile_pad = _rows_covered(th * tw, (32, 64))
    if rows_pad is None or tile_pad is None:
        return None
    layout = _layout(th, tw, cap, rows_pad, tile_pad, channels, heads, itemsize)
    if layout["smem"] + _STATIC_SMEM > SMEM_BYTES:
        return None
    return TilePlan(
        th=th, tw=tw, tiles_h=_ceil(clen_h, th), tiles_w=_ceil(clen_w, tw),
        cap=cap, rows_pad=rows_pad, tile_pad=tile_pad, **layout,
    )


@functools.lru_cache(maxsize=256)
def _tile_plan(
    height: int,
    width: int,
    kernel_size: int,
    dilation: int,
    channels: int,
    heads: int,
    itemsize: int,
    batch: int = 1,
) -> TilePlan:
    """The tile of one launch: among the tiles of 1 to 16 positions a side
    that ``_plan_for`` can lay out, the one with the least estimated time
    over the ``batch * dilation^2`` coset images (waves of one block an SM
    times ``_block_clocks``). Raises if none fits."""
    best = None
    for th in _TILE_SIDES:
        for tw in _TILE_SIDES:
            plan = _plan_for(
                th, tw, height, width, kernel_size, dilation, channels, heads,
                itemsize,
            )
            if plan is None:
                continue
            layout = dataclasses.asdict(plan)
            blocks = batch * dilation * dilation * plan.tiles_h * plan.tiles_w
            clocks = _block_clocks(
                th, tw, plan.rows_pad, plan.tile_pad, layout, channels, heads,
                kernel_size,
            )
            key = (_ceil(blocks, SMS) * clocks, -th * tw)
            if best is None or key < best[0]:
                best = (key, plan)
    if best is None:
        raise ValueError(
            f"na_block_fwd: no tile fits {SMEM_BYTES} bytes of shared memory "
            f"at C = {channels}, {heads} heads, kernel_size {kernel_size} "
            f"and {itemsize}-byte x"
        )
    return best[1]


def _sweep_counts(channels: int, heads: int) -> T.Tuple[int, int]:
    """(QKV sweeps a pass, projection sweeps): the kernel's products run
    over column sweeps of 192 (a pass's q, k and v columns) and 256 (the
    output channels)."""
    dp, group, _ = head_layout(channels, heads)
    return (
        _ceil(3 * group * dp, _WIDTH_QKV),
        _ceil(padded_channels(channels), _WIDTH_PROJ),
    )


def prepare_weights(
    params: T.Mapping[str, Tensor],
    num_heads: int,
    device=None,
    dtype: torch.dtype = torch.bfloat16,
) -> T.Dict[str, Tensor]:
    """The parameters as the kernel reads them, cast as
    ``_na_block_pallas_d1`` casts them: the two weights in ``dtype`` (bf16;
    the CPU tests' emulation also takes fp64), the LayerNorm vectors and
    the biases in fp32 (fp64 with fp64 weights).

    The weights are laid out in the order and shape of the kernel's copies:
    a sweep's rows are padded to its width + 8 columns, so each copy of 32
    rows is one contiguous range that lands as the shared-memory rows the
    tensor cores read.

    - ``w_qkv``: (passes, sweeps, Cp, 200): a pass's q, k and v columns
      side by side (each head padded to ``dp`` columns), cut into sweeps of
      192; rows past C are zero.
    - ``b_qkv``: (passes, 3 p) in the same columns.
    - ``w_proj``: (sweeps, heads * dp, 264): head n's rows at n * dp, the
      output channels cut into sweeps of 256.
    Padding is zero everywhere, so it adds nothing to any sum.
    """
    w_qkv = params["w_qkv"]
    channels = w_qkv.shape[0]
    heads = num_heads
    head_dim = channels // heads
    cp = padded_channels(channels)
    dp, group, passes = head_layout(channels, heads)
    p = group * dp
    sweeps_qkv, sweeps_proj = _sweep_counts(channels, heads)
    vec_dtype = torch.float64 if dtype == torch.float64 else torch.float32
    device = w_qkv.device if device is None else device
    pad = torch.nn.functional.pad

    def f(key):
        return params[key].to(device=device, dtype=vec_dtype)

    # (C, 3, heads, D) -> (passes, C, 3, group, dp) -> (passes, Cp, 3 p)
    w = pad(f("w_qkv").reshape(channels, 3, heads, head_dim), (0, dp - head_dim))
    w = w.reshape(channels, 3, passes, p).permute(2, 0, 1, 3)
    w = pad(w.reshape(passes, channels, 3 * p), (0, 0, 0, cp - channels))
    # -> (passes, sweeps, Cp, 192 + 8)
    w = pad(w, (0, sweeps_qkv * _WIDTH_QKV - 3 * p))
    w = w.reshape(passes, cp, sweeps_qkv, _WIDTH_QKV).permute(0, 2, 1, 3)
    w = pad(w, (0, 8))
    b = pad(f("b_qkv").reshape(3, heads, head_dim), (0, dp - head_dim))
    b = b.reshape(3, passes, p).permute(1, 0, 2)
    # (heads * dp, Cp) -> (sweeps, heads * dp, 256 + 8)
    proj = f("w_proj").reshape(heads, head_dim, channels)
    proj = pad(proj, (0, sweeps_proj * _WIDTH_PROJ - channels, 0, dp - head_dim))
    proj = proj.reshape(heads * dp, sweeps_proj, _WIDTH_PROJ).permute(1, 0, 2)
    proj = pad(proj, (0, 8))
    return {
        **{
            key: f(key).contiguous()
            for key in ("ln1_scale", "ln1_bias", "b_proj", "ln2_scale", "ln2_bias")
        },
        "w_qkv": w.to(dtype).contiguous(),
        "b_qkv": b.reshape(passes, 3 * p).contiguous(),
        "w_proj": proj.to(dtype).contiguous(),
    }


def unpack_weights(weights: T.Mapping[str, Tensor], channels: int, heads: int):
    """``prepare_weights``' two weights back as plain matrices: w_qkv
    (passes, Cp, 3 p) and w_proj (heads * dp, Cp)."""
    cp = padded_channels(channels)
    dp, group, passes = head_layout(channels, heads)
    w = weights["w_qkv"][..., :_WIDTH_QKV].permute(0, 2, 1, 3)
    w = w.reshape(passes, cp, -1)[..., : 3 * group * dp]
    proj = weights["w_proj"][..., :_WIDTH_PROJ].permute(1, 0, 2)
    proj = proj.reshape(heads * dp, -1)[:, :cp]
    return w, proj


def _vector_width(x: Tensor, out: Tensor) -> int:
    """16 / itemsize when x's and out's pointers are 16-byte aligned and a
    pixel's C channels are whole 16-byte chunks; else 1 (the kernel's
    element-wise path)."""
    vec = 16 // x.element_size()
    channels = x.shape[-1]
    if channels % vec or x.data_ptr() % 16 or out.data_ptr() % 16:
        return 1
    return vec


def launch_prepared(
    x: Tensor,
    weights: T.Mapping[str, Tensor],
    num_heads: int,
    kernel_size: int,
    dilation: int = 1,
) -> Tensor:
    """Launch ``na_block_fwd`` on the current stream on weights from
    ``prepare_weights`` (bf16, on x's device): the fused block's forward
    for a CUDA ``x`` (B, H, W, C) in fp32 or bf16, kernel_size 1 or 3, any
    dilation (windows clamped within each coset), C up to 512; returns a
    new contiguous tensor in x's dtype. Anything else raises."""
    if x.device.type != "cuda":
        raise ValueError(
            f"na_block_fwd: x must lie on a CUDA device, got {x.device}"
        )
    if x.dtype not in _DTYPES:
        raise TypeError(
            f"na_block_fwd: x has dtype {x.dtype}; the kernel takes "
            f"{sorted(map(str, _DTYPES))}"
        )
    if x.dim() != 4:
        raise ValueError(f"na_block_fwd: x must be (B, H, W, C), got {x.shape}")
    if kernel_size not in (1, 3):
        raise ValueError(
            f"na_block_fwd: kernel_size must be 1 or 3, got {kernel_size}"
        )
    batch, height, width, channels = x.shape
    if channels > _MAX_CHANNELS or num_heads < 1 or channels % num_heads:
        raise ValueError(
            f"na_block_fwd: C = {channels} with {num_heads} heads; the kernel "
            f"takes C <= {_MAX_CHANNELS} divided by the heads"
        )
    check_spatial(height, width, kernel_size, dilation)
    cp = padded_channels(channels)
    dp, _, passes = head_layout(channels, num_heads)
    sweeps_qkv, sweeps_proj = _sweep_counts(channels, num_heads)
    want = {
        "w_qkv": (passes, sweeps_qkv, cp, _WIDTH_QKV + 8),
        "w_proj": (sweeps_proj, num_heads * dp, _WIDTH_PROJ + 8),
    }
    for key, shape in want.items():
        value = weights[key]
        if tuple(value.shape) != shape or value.dtype != torch.bfloat16:
            raise ValueError(
                f"na_block_fwd: prepared {key} must be bf16 {shape}, got "
                f"{value.dtype} {tuple(value.shape)}"
            )
    for key, value in weights.items():
        if value.device != x.device or not value.is_contiguous():
            raise ValueError(
                f"na_block_fwd: prepared {key} must be contiguous on "
                f"{x.device}"
            )
    x = x.contiguous()
    out = torch.empty_like(x)
    plan = _tile_plan(
        height, width, kernel_size, dilation, channels, num_heads,
        x.element_size(), batch,
    )
    build.launch(
        "na_block_fwd", "na_block_fwd", x.device,
        _DTYPES[x.dtype], _vector_width(x, out), x.data_ptr(),
        weights["ln1_scale"].data_ptr(), weights["ln1_bias"].data_ptr(),
        weights["w_qkv"].data_ptr(), weights["b_qkv"].data_ptr(),
        weights["w_proj"].data_ptr(), weights["b_proj"].data_ptr(),
        weights["ln2_scale"].data_ptr(), weights["ln2_bias"].data_ptr(),
        out.data_ptr(),
        batch, height, width, channels, num_heads, kernel_size, dilation,
        plan.args, LN_EPS,
    )
    LAUNCHES["na_block_fwd"] += 1
    return out


def launch_na_block_fwd(
    x: Tensor,
    params: T.Mapping[str, Tensor],
    num_heads: int,
    kernel_size: int,
    dilation: int = 1,
) -> Tensor:
    """``prepare_weights`` then ``launch_prepared``: the fused block's
    forward for a CUDA ``x`` on the block's eight parameters (any float
    dtype, any device; cast and laid out on every call)."""
    check_block(x, params, num_heads)
    weights = prepare_weights(params, num_heads, x.device)
    return launch_prepared(x, weights, num_heads, kernel_size, dilation)
