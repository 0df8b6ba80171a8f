"""The hand-written Hopper kernel for neighborhood attention (forward).

``csrc/na2d_fwd.cu`` replaces the TPU kernel
``cultionet_tpu/ops/natten_pallas.py::_na2d_fwd_kernel``; its plain PyTorch
version is ``ops/natten.py::neighborhood_attention_2d``.

Build: at first use, ``nvcc`` compiles the source for ``sm_90a`` into a
shared library with a plain C interface under ``cultionet_tpu_torch/_build/``
(named by the source's hash, so an edited source rebuilds), and ``ctypes``
loads it. Nothing here runs when the module is imported, so the package
imports on a machine with no ``nvcc`` and no card.

``LAUNCHES["na2d_fwd"]`` counts the kernel's launches, so a run can show
that its path went through the kernel.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import typing as T
from pathlib import Path

import torch

from .natten import check_spatial

Tensor = torch.Tensor

SOURCE = Path(__file__).resolve().parent / "csrc" / "na2d_fwd.cu"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

LAUNCHES: T.Dict[str, int] = {"na2d_fwd": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib: T.Optional[ctypes.CDLL] = None
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
        "na2d_fwd: nvcc not found (set CUDA_HOME or put nvcc on PATH); the "
        "CUDA kernel cannot be built"
    )


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libna2d_fwd_{digest}.so"


def compile_library(verbose: bool = False) -> T.Tuple[Path, str]:
    """Compile the kernel if its library is missing; returns the library
    path and nvcc's messages (``verbose`` adds ``-Xptxas -v``: registers,
    shared memory and spills per kernel). Raises if nvcc fails."""
    out = library_path()
    if out.exists() and not verbose:
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = list(NVCC_FLAGS) + (["-Xptxas", "-v"] if verbose else [])
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *flags, "-o", tmp, str(SOURCE)],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"na2d_fwd: nvcc failed ({proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, proc.stdout + proc.stderr


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel's library once per process."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = compile_library()
            lib = ctypes.CDLL(str(path))
            lib.na2d_fwd.argtypes = [
                ctypes.c_int,
                ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_longlong),
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_void_p,
            ]
            lib.na2d_fwd.restype = ctypes.c_int
            lib.na2d_error_string.argtypes = [ctypes.c_int]
            lib.na2d_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check_inputs(q: Tensor, k: Tensor, v: Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(
                f"na2d_cuda: {name} must lie on q's CUDA device, got "
                f"{t.device}"
            )
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise TypeError(
                f"na2d_cuda: {name} has dtype {t.dtype}; q, k and v must "
                f"share one of {sorted(map(str, _DTYPES))}"
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


def launch_na2d_fwd(
    q: Tensor, k: Tensor, v: Tensor, kernel_size: int, dilation: int
) -> Tensor:
    """Launch the kernel on the current stream; returns a new contiguous
    ``(B, H, W, heads, head_dim)`` tensor in q's dtype."""
    _check_inputs(q, k, v)
    batch, height, width, heads, head_dim = q.shape
    check_spatial(height, width, kernel_size, dilation)
    lib = load_library()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:4], *k.stride()[:4], *v.stride()[:4]
    )
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.na2d_fwd(
            _DTYPES[q.dtype],
            q.data_ptr(),
            k.data_ptr(),
            v.data_ptr(),
            out.data_ptr(),
            strides,
            batch,
            height,
            width,
            heads,
            head_dim,
            kernel_size,
            dilation,
            stream,
        )
    if code != 0:
        raise RuntimeError(
            f"na2d_fwd launch failed: {lib.na2d_error_string(code).decode()}"
        )
    LAUNCHES["na2d_fwd"] += 1
    return out


class _NA2dFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kernel_size, dilation):
        return launch_na2d_fwd(q, k, v, kernel_size, dilation)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError("NA backward kernel: training slice")


def na2d_cuda(
    q: Tensor, k: Tensor, v: Tensor, kernel_size: int, dilation: int = 1
) -> Tensor:
    """Neighborhood attention on CUDA tensors through the hand-written kernel.

    ``kernel_size == 1`` returns ``v`` (a one-key softmax is 1). Every other
    shape with ``min(H, W) >= kernel_size * dilation`` runs the kernel; any
    failure raises. Gradients are not implemented yet and raise.
    """
    check_spatial(q.shape[1], q.shape[2], kernel_size, dilation)
    if kernel_size == 1:
        return v
    return _NA2dFwd.apply(q, k, v, kernel_size, dilation)
