"""The hand-written Hopper kernels for LayerNorm over narrow rows.

``csrc/layer_norm_fwd.cu`` (``layer_norm_rows_fwd``, #8) replaces no TPU
kernel; its plain version is ``ops/layer_norm.py::layer_norm_reference``
(``F.layer_norm``). In training its form with statistics
(``layer_norm_rows_fwd_train``) also writes each row's mean and rstd, and
``csrc/layer_norm_bwd.cu`` (``layer_norm_rows_bwd``) computes the input,
weight and bias gradients from them: ``layer_norm_rows_cuda`` is the
autograd function of the two. ``ops/build.py`` builds both libraries at
first use; their shared launch plan is ``csrc/layer_norm_common.cuh``.

The kernels choose each launch's plan themselves, from the type and the
width (elements a chunk, lanes a row, chunks a lane, rows a thread, grid).
``launch_plan`` mirrors that choice in pure Python, so the CPU tests check
that a plan covers every row and chunk once; ``card_plan`` asks a library
for the plan it launches, and the card tests hold the two equal.
``LAUNCHES`` counts the launches, one per wrapper call: the eval forward
``layer_norm_rows``, the training forward ``layer_norm_rows_train`` and the
backward ``layer_norm_rows_bwd`` (its two launches, the rows' and the
partial sums', counted once).
"""

import ctypes
import dataclasses
import functools
import typing as T

import torch

from . import build

Tensor = torch.Tensor

LAUNCHES: T.Dict[str, int] = {
    "layer_norm_rows": 0, "layer_norm_rows_train": 0, "layer_norm_rows_bwd": 0,
}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PTR, _INT, _LONG = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PLAN = [_INT, _LONG, _INT, ctypes.POINTER(_INT)]  # dtype, rows, width, out
build.register(
    build.Library(
        name="layer_norm_fwd",
        source="layer_norm_fwd.cu",
        headers=("layer_norm_common.cuh",),
        signatures={
            # dtype, x, weight, bias, y, rows, width, eps, stream
            "layer_norm_rows_fwd": [
                _INT, _PTR, _PTR, _PTR, _PTR, _LONG, _INT, ctypes.c_float, _PTR,
            ],
            # dtype, x, weight, bias, y, mean, rstd, rows, width, eps, stream
            "layer_norm_rows_fwd_train": [
                _INT, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _LONG, _INT,
                ctypes.c_float, _PTR,
            ],
            # out: the six numbers of a plan
            "layer_norm_rows_plan": _PLAN,
        },
        error_string="layer_norm_error_string",
    )
)
build.register(
    build.Library(
        name="layer_norm_bwd",
        source="layer_norm_bwd.cu",
        headers=("layer_norm_common.cuh",),
        signatures={
            # dtype, x, dy, mean, rstd, weight, dx, dweight, dbias, partial,
            # partial blocks, rows, width, stream
            "layer_norm_rows_bwd": [
                _INT, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
                _LONG, _LONG, _INT, _PTR,
            ],
            "layer_norm_rows_bwd_plan": _PLAN,
        },
        error_string="layer_norm_bwd_error_string",
    )
)

# The kernel's constants (csrc/layer_norm_fwd.cu): threads a block; chunks
# a lane at most; 16-byte chunks a thread keeps in flight (rows a thread x
# chunks a lane).
THREADS = 256
MAX_CHUNKS_PER_LANE = 8
_CHUNKS_IN_FLIGHT = 4


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """One launch: rows are read in chunks of ``vec`` elements; ``lanes``
    lanes hold a row, each ``cpl`` of its chunks (chunk c in lane
    c % lanes; the chunks past the row's masked); each thread takes
    ``rows_per_thread`` rows. A warp holds 32 / lanes rows side by side; a
    block's tile is ``block_rows`` rows, tile t's row
    ``t * block_rows + warp * rows_per_thread * groups + r * groups + g``
    for warp, row r of the thread and lane group g. Block b walks tiles
    b, b + grid, ... of the ``tiles``; rows past ``rows`` are masked.
    ``blocks_per_sm`` is what the kernel's launch bounds keep resident."""

    rows: int
    width: int
    vec: int
    lanes: int
    cpl: int
    rows_per_thread: int
    block_rows: int
    tiles: int
    grid: int
    blocks_per_sm: int


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def chunk_elements(width: int, itemsize: int) -> int:
    """Elements a load: the most, at most 16 bytes, that divide ``width``."""
    vec = 16 // itemsize
    while width % vec:
        vec //= 2
    return vec


def check_width(width: int, itemsize: int) -> None:
    """Raises unless the kernel takes rows of ``width`` elements of
    ``itemsize`` bytes: at most 32 lanes x 8 chunks a row."""
    if width < 1 or width // chunk_elements(width, itemsize) > 32 * MAX_CHUNKS_PER_LANE:
        raise ValueError(
            f"layer_norm_cuda: width {width} of {itemsize}-byte elements is "
            f"not 1 to {32 * MAX_CHUNKS_PER_LANE} loads of up to 16 bytes"
        )


@functools.lru_cache(maxsize=256)
def launch_plan(
    rows: int, width: int, itemsize: int, sms: int = 132, backward: bool = False
) -> LaunchPlan:
    """The plan of one launch over ``rows`` rows of ``width`` elements of
    ``itemsize`` bytes on a card of ``sms`` SMs, as the kernels'
    ``make_plan`` and ``grid_for`` choose it: the forward's, or with
    ``backward`` the backward row kernel's (the same tiles, half the
    resident blocks; its grid is the number of (2, width) partials)."""
    check_width(width, itemsize)
    vec = chunk_elements(width, itemsize)
    chunks = width // vec
    lanes = min(32, _pow2_at_least(chunks))
    cpl = _pow2_at_least(-(-chunks // lanes))
    rows_per_thread = max(1, _CHUNKS_IN_FLIGHT // cpl)
    block_rows = THREADS // 32 * (32 // lanes) * rows_per_thread
    tiles = -(-rows // block_rows)
    blocks_per_sm = (4 if cpl == 1 else 2) // (2 if backward else 1)
    return LaunchPlan(
        rows=rows, width=width, vec=vec, lanes=lanes, cpl=cpl,
        rows_per_thread=rows_per_thread, block_rows=block_rows, tiles=tiles,
        grid=max(1, min(tiles, sms * blocks_per_sm)),
        blocks_per_sm=blocks_per_sm,
    )


def card_plan(
    dtype: torch.dtype, rows: int, width: int, device: torch.device,
    backward: bool = False,
) -> T.Dict[str, int]:
    """The plan ``layer_norm_rows_fwd`` (or with ``backward``
    ``layer_norm_rows_bwd``) launches over ``rows`` rows of ``width``
    elements of ``dtype`` on ``device``, from the library."""
    name, fn = ("layer_norm_bwd", "layer_norm_rows_bwd_plan") if backward else (
        "layer_norm_fwd", "layer_norm_rows_plan")
    lib = build.load_library(name)
    out = (_INT * 6)()
    with torch.cuda.device(device):
        code = getattr(lib, fn)(_DTYPES[dtype], rows, width, out)
    if code != 0:
        message = getattr(lib, build.LIBRARIES[name].error_string)(code).decode()
        raise ValueError(f"{fn}: {message}")
    keys = ("vec", "lanes", "cpl", "rows_per_thread", "block_rows", "grid")
    return dict(zip(keys, out))


def _alignment(x: Tensor) -> int:
    """Bytes of the kernels' loads on rows of x: what its pointers align to."""
    return chunk_elements(x.shape[-1], x.element_size()) * x.element_size()


def _check_inputs(
    x: Tensor, weight: Tensor, bias: T.Optional[Tensor] = None,
    grad: T.Optional[Tensor] = None,
) -> int:
    """Raises unless the kernels take these tensors (x and the output's
    gradient of one shape, weight and bias along x's last axis, all of one
    type, contiguous, aligned, on x's card); returns the width."""
    named = [("x", x), ("weight", weight)] + [
        (name, t) for name, t in (("bias", bias), ("grad", grad)) if t is not None
    ]
    for name, t in named:
        if t.dtype not in _DTYPES or t.dtype != x.dtype:
            raise TypeError(
                f"layer_norm_cuda: {name} has dtype {t.dtype}; x, weight and "
                f"bias must share one of {sorted(map(str, _DTYPES))}"
            )
    width = x.shape[-1] if x.dim() else 0
    if weight.shape != (width,) or (bias is not None and bias.shape != (width,)):
        raise ValueError(
            f"layer_norm_cuda: weight {tuple(weight.shape)} and bias "
            f"{None if bias is None else tuple(bias.shape)} must be ({width},), "
            f"x's last axis"
        )
    if grad is not None and grad.shape != x.shape:
        raise ValueError(
            f"layer_norm_cuda: the gradient {tuple(grad.shape)} must be shaped "
            f"like x {tuple(x.shape)}"
        )
    check_width(width, x.element_size())
    align = _alignment(x)
    for name, t in named:
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(
                f"layer_norm_cuda: {name} must be contiguous and "
                f"{align}-byte aligned"
            )
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(
                f"layer_norm_cuda: {name} must lie on x's CUDA device, got "
                f"{t.device}"
            )
    return width


def launch_layer_norm_rows(
    x: Tensor, weight: Tensor, bias: Tensor, eps: float
) -> Tensor:
    """Launch ``layer_norm_rows_fwd`` on the current stream: LayerNorm of a
    contiguous x over its last axis; returns a new contiguous tensor shaped
    and typed like x."""
    width = _check_inputs(x, weight, bias)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    rows = x.numel() // width
    if rows == 0:
        return out
    build.launch(
        "layer_norm_fwd", "layer_norm_rows_fwd", x.device,
        _DTYPES[x.dtype], x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        out.data_ptr(), rows, width, float(eps),
    )
    LAUNCHES["layer_norm_rows"] += 1
    return out


def launch_layer_norm_rows_train(
    x: Tensor, weight: Tensor, bias: Tensor, eps: float
) -> T.Tuple[Tensor, Tensor, Tensor]:
    """Launch ``layer_norm_rows_fwd_train`` on the current stream: the
    forward of ``launch_layer_norm_rows`` and each row's fp32 mean and rstd
    (x's shape without its last axis)."""
    width = _check_inputs(x, weight, bias)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    mean = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    rows = x.numel() // width
    if rows:
        build.launch(
            "layer_norm_fwd", "layer_norm_rows_fwd_train", x.device,
            _DTYPES[x.dtype], x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            out.data_ptr(), mean.data_ptr(), rstd.data_ptr(), rows, width,
            float(eps),
        )
        LAUNCHES["layer_norm_rows_train"] += 1
    return out, mean, rstd


@functools.lru_cache(maxsize=16)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_layer_norm_rows_bwd(
    x: Tensor, grad: Tensor, mean: Tensor, rstd: Tensor, weight: Tensor
) -> T.Tuple[Tensor, Tensor, Tensor]:
    """Launch ``layer_norm_rows_bwd`` on the current stream: from x, the
    output's gradient and the forward's mean and rstd, the gradients of x
    (shaped and typed like x), of the weight and of the bias (typed like
    the weight). Scratch: one (2, width) fp32 partial a block of the plan's
    grid, from the caching allocator."""
    width = _check_inputs(x, weight, grad=grad)
    rows = x.numel() // width
    for name, t in (("mean", mean), ("rstd", rstd)):
        if (t.dtype != torch.float32 or t.numel() != rows or not t.is_contiguous()
                or t.device != x.device):
            raise ValueError(
                f"layer_norm_cuda: {name} must be {rows} contiguous fp32 values on "
                f"x's device"
            )
    plan = launch_plan(rows, width, x.element_size(), _sm_count(x.device), backward=True)
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    dweight = torch.empty_like(weight)
    dbias = torch.empty_like(weight)
    partial = torch.empty((plan.grid, 2, width), dtype=torch.float32, device=x.device)
    build.launch(
        "layer_norm_bwd", "layer_norm_rows_bwd", x.device,
        _DTYPES[x.dtype], x.data_ptr(), grad.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), weight.data_ptr(), dx.data_ptr(), dweight.data_ptr(),
        dbias.data_ptr(), partial.data_ptr(), plan.grid, rows, width,
    )
    LAUNCHES["layer_norm_rows_bwd"] += 1
    return dx, dweight, dbias


def _rows_layout(t: Tensor) -> Tensor:
    """t as the kernels read it: contiguous and aligned to their loads (a
    copy only where it is not)."""
    t = t.contiguous()
    return t.clone() if t.numel() and t.data_ptr() % _alignment(t) else t


class _LayerNormRows(torch.autograd.Function):
    """LayerNorm over the last axis: the training forward, saving x, the
    weight and each row's mean and rstd; the backward kernel."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        out, mean, rstd = launch_layer_norm_rows_train(x, weight, bias, eps)
        ctx.save_for_backward(x, weight, mean, rstd)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, weight, mean, rstd = ctx.saved_tensors
        dx, dweight, dbias = launch_layer_norm_rows_bwd(
            x, _rows_layout(grad), mean, rstd, weight
        )
        return dx, dweight, dbias, None


def layer_norm_rows_cuda(x: Tensor, weight: Tensor, bias: Tensor, eps: float) -> Tensor:
    """LayerNorm of x over its last axis on CUDA tensors through the
    training kernels, differentiable in x, the weight and the bias; any
    failure raises. Host-synchronous nowhere, so a CUDA graph captures it."""
    return _LayerNormRows.apply(_rows_layout(x), weight, bias, eps)
