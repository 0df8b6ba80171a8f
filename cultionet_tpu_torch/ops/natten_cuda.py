"""The hand-written Hopper kernels for neighborhood attention.

``csrc/na2d_fwd.cu`` replaces the TPU kernels
``cultionet_tpu/ops/natten_pallas.py::_na2d_fwd_kernel`` (``na2d_fwd``) and
``_na2d_fwd_drop_kernel`` (``na2d_fwd_drop``); ``csrc/na2d_bwd.cu`` replaces
``_na2d_bwd_kernel`` (``na2d_bwd``) and ``_na2d_bwd_drop_kernel``
(``na2d_bwd_drop``). Their plain PyTorch version is
``ops/natten.py::neighborhood_attention_2d`` (with
``dropout_keep_mask`` for the dropout pair) and its autograd.

Build: at first use, ``nvcc`` compiles each source for ``sm_90a`` into a
shared library with a plain C interface under ``cultionet_tpu_torch/_build/``
(named by the hash of the source and its header, so an edited source
rebuilds), and ``ctypes`` loads it. Nothing here runs when the module is
imported, so the package imports on a machine with no ``nvcc`` and no card.

``LAUNCHES`` counts each kernel's launches, one per wrapper call that
launches it (the backward's two passes are one launch of ``na2d_bwd``), so
a run can show that its path went through the kernels.
"""

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import threading
import typing as T
from pathlib import Path

import torch

from .natten import check_dropout_rate, check_spatial

Tensor = torch.Tensor

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"na2d_fwd": CSRC / "na2d_fwd.cu", "na2d_bwd": CSRC / "na2d_bwd.cu"}
HEADER = CSRC / "na2d_common.cuh"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

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
_DIMS = [_INT] * 7  # B, H, W, N, D, kernel_size, dilation
_DROP = [_PTR, _UINT, _FLOAT]  # seed pointer, keep threshold, 1 / (1 - p)
_SIGNATURES = {
    "na2d_fwd": {
        "na2d_fwd": [_INT, _PTR, _PTR, _PTR, _PTR, _STRIDES, *_DIMS, _PTR],
        "na2d_fwd_drop": [
            _INT, _PTR, _PTR, _PTR, _PTR, _STRIDES, *_DIMS, *_DROP, _PTR
        ],
    },
    "na2d_bwd": {
        "na2d_bwd": [
            _INT, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _STRIDES,
            *_DIMS, _PTR,
        ],
        "na2d_bwd_drop": [
            _INT, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _STRIDES,
            *_DIMS, *_DROP, _PTR,
        ],
    },
}

_libs: T.Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = []
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    for path in candidates:
        if os.path.isfile(path):
            return path
    raise RuntimeError(
        "na2d: nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels cannot be built"
    )


def library_path(name: str) -> Path:
    digest = hashlib.sha256(
        SOURCES[name].read_bytes() + HEADER.read_bytes()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def compile_library(name: str, verbose: bool = False) -> T.Tuple[Path, str]:
    """Compile library ``name`` (a key of ``SOURCES``) if it is missing;
    returns the library path and nvcc's messages (``verbose`` adds
    ``-Xptxas -v``: registers, shared memory and spills per kernel). Raises
    if nvcc fails. Distinct names may build in parallel."""
    out = library_path(name)
    if out.exists() and not verbose:
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = list(NVCC_FLAGS) + (["-Xptxas", "-v"] if verbose else [])
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *flags, "-o", tmp, str(SOURCES[name])],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"{name}: nvcc failed ({proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, proc.stdout + proc.stderr


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load library ``name`` once per process."""
    with _lock:
        if name not in _libs:
            path, _ = compile_library(name)
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.na2d_error_string.argtypes = [ctypes.c_int]
            lib.na2d_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


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


def _call(lib: ctypes.CDLL, fn: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, fn)(*args, stream)
    if code != 0:
        raise RuntimeError(
            f"{fn} launch failed: {lib.na2d_error_string(code).decode()}"
        )


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
    lib = load_library("na2d_fwd")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:4], *k.stride()[:4], *v.stride()[:4]
    )
    _call(
        lib, fn, q.device,
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), strides,
        batch, height, width, heads, head_dim, kernel_size, dilation,
        *drop,
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
    lib = load_library("na2d_bwd")
    dq, dk, dv = (
        torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(3)
    )
    stats = torch.empty(
        (batch * height * width * heads, 3), dtype=torch.float32,
        device=q.device,
    )
    strides = (ctypes.c_longlong * 16)(
        *q.stride()[:4], *k.stride()[:4], *v.stride()[:4], *g.stride()[:4]
    )
    _call(
        lib, fn, q.device,
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        stats.data_ptr(), strides,
        batch, height, width, heads, head_dim, kernel_size, dilation,
        *drop,
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
