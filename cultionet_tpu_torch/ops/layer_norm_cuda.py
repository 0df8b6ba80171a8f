"""The hand-written Hopper kernel for LayerNorm over narrow rows.

``csrc/layer_norm_fwd.cu`` (``layer_norm_rows_fwd``) replaces no TPU kernel;
its plain version is ``ops/layer_norm.py::layer_norm_reference``
(``F.layer_norm``). ``ops/build.py`` builds it at first use.

The kernel chooses each launch's plan itself, from the type and the width
(elements a chunk, lanes a row, chunks a lane, rows a thread, grid).
``launch_plan`` mirrors that choice in pure Python, so the CPU tests check
that a plan covers every row and chunk once; ``card_plan`` asks the library
for the plan it launches, and the card tests hold the two equal.
``LAUNCHES`` counts the kernel's launches, one per wrapper call, and each
launch also adds to the program counter ``layernorm_kernels``
(``utils/profiling.py``).
"""

import ctypes
import dataclasses
import functools
import typing as T

import torch

from . import build
from ..utils import profiling

Tensor = torch.Tensor

LAUNCHES: T.Dict[str, int] = {"layer_norm_rows": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PTR, _INT, _LONG = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
build.register(
    build.Library(
        name="layer_norm_fwd",
        source="layer_norm_fwd.cu",
        headers=(),
        signatures={
            # dtype, x, weight, bias, y, rows, width, eps, stream
            "layer_norm_rows_fwd": [
                _INT, _PTR, _PTR, _PTR, _PTR, _LONG, _INT, ctypes.c_float, _PTR,
            ],
            # dtype, rows, width, out: the six numbers of a plan
            "layer_norm_rows_plan": [_INT, _LONG, _INT, ctypes.POINTER(_INT)],
        },
        error_string="layer_norm_error_string",
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
def launch_plan(rows: int, width: int, itemsize: int, sms: int = 132) -> LaunchPlan:
    """The plan of one launch over ``rows`` rows of ``width`` elements of
    ``itemsize`` bytes on a card of ``sms`` SMs, as the kernel's
    ``make_plan`` and ``grid_for`` choose it."""
    check_width(width, itemsize)
    vec = chunk_elements(width, itemsize)
    chunks = width // vec
    lanes = min(32, _pow2_at_least(chunks))
    cpl = _pow2_at_least(-(-chunks // lanes))
    rows_per_thread = max(1, _CHUNKS_IN_FLIGHT // cpl)
    block_rows = THREADS // 32 * (32 // lanes) * rows_per_thread
    tiles = -(-rows // block_rows)
    blocks_per_sm = 4 if cpl == 1 else 2
    return LaunchPlan(
        rows=rows, width=width, vec=vec, lanes=lanes, cpl=cpl,
        rows_per_thread=rows_per_thread, block_rows=block_rows, tiles=tiles,
        grid=max(1, min(tiles, sms * blocks_per_sm)),
        blocks_per_sm=blocks_per_sm,
    )


def card_plan(
    dtype: torch.dtype, rows: int, width: int, device: torch.device
) -> T.Dict[str, int]:
    """The plan ``layer_norm_rows_fwd`` launches over ``rows`` rows of
    ``width`` elements of ``dtype`` on ``device``, from the library."""
    lib = build.load_library("layer_norm_fwd")
    out = (_INT * 6)()
    with torch.cuda.device(device):
        code = lib.layer_norm_rows_plan(_DTYPES[dtype], rows, width, out)
    if code != 0:
        message = lib.layer_norm_error_string(code).decode()
        raise ValueError(f"layer_norm_rows_plan: {message}")
    keys = ("vec", "lanes", "cpl", "rows_per_thread", "block_rows", "grid")
    return dict(zip(keys, out))


def _check_inputs(x: Tensor, weight: Tensor, bias: Tensor) -> int:
    """Raises unless the kernel takes these tensors; returns the width."""
    named = (("x", x), ("weight", weight), ("bias", bias))
    for name, t in named:
        if t.dtype not in _DTYPES or t.dtype != x.dtype:
            raise TypeError(
                f"layer_norm_cuda: {name} has dtype {t.dtype}; x, weight and "
                f"bias must share one of {sorted(map(str, _DTYPES))}"
            )
    width = x.shape[-1] if x.dim() else 0
    if weight.shape != (width,) or bias.shape != (width,):
        raise ValueError(
            f"layer_norm_cuda: weight {tuple(weight.shape)} and bias "
            f"{tuple(bias.shape)} must be ({width},), x's last axis"
        )
    check_width(width, x.element_size())
    align = chunk_elements(width, x.element_size()) * x.element_size()
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
    profiling.add_count("layernorm_kernels")
    return out
