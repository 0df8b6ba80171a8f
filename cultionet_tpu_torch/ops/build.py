"""Build and load the hand-written CUDA kernels.

Each kernel family registers its libraries here (``register``): one CUDA
source with a plain C interface, the headers it includes, the ctypes
signatures of its entry points and the name of its error-string function.
At first use ``nvcc`` compiles each library for ``sm_90a`` into a shared
library under ``cultionet_tpu_torch/_build/`` (named by the hash of its
source and headers, so an edited source rebuilds), and ``ctypes`` loads it.
Nothing here runs when the module is imported, so the package imports on a
machine with no ``nvcc`` and no card. Distinct libraries may build in
parallel (one ``nvcc`` each).
"""

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import typing as T
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)


@dataclasses.dataclass(frozen=True)
class Library:
    """One shared library: ``source`` (under ``csrc/``), the ``headers`` it
    includes, ``signatures`` (entry point -> ctypes argtypes; each returns a
    ``cudaError_t`` as an int) and ``error_string``, the entry point that
    turns such a code into text."""

    name: str
    source: str
    headers: T.Tuple[str, ...]
    signatures: T.Mapping[str, T.Sequence[T.Any]]
    error_string: str


LIBRARIES: T.Dict[str, Library] = {}
_libs: T.Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def register(library: Library) -> Library:
    LIBRARIES[library.name] = library
    return library


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
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels cannot be built"
    )


def library_path(name: str) -> Path:
    library = LIBRARIES[name]
    digest = hashlib.sha256()
    for file in (library.source, *library.headers):
        digest.update((CSRC / file).read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def compile_library(name: str) -> T.Tuple[Path, str]:
    """Compile library ``name`` if it is missing; returns the library path
    and nvcc's messages with ``-Xptxas -v`` (registers, shared memory and
    spills per kernel), kept beside the library so a built one reports them
    too. Raises if nvcc fails."""
    out = library_path(name)
    report = out.with_suffix(".ptxas.txt")
    if out.exists() and report.exists():
        return out, report.read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = [*NVCC_FLAGS, "-Xptxas", "-v"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *flags, "-o", tmp, str(CSRC / LIBRARIES[name].source)],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"{name}: nvcc failed ({proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        report.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, proc.stdout + proc.stderr


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load library ``name`` once per process."""
    with _lock:
        if name not in _libs:
            library = LIBRARIES[name]
            path, _ = compile_library(name)
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in library.signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            error_string = getattr(lib, library.error_string)
            error_string.argtypes = [ctypes.c_int]
            error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def launch(name: str, fn: str, device: torch.device, *args) -> None:
    """Call entry point ``fn`` of library ``name`` with ``args`` and the
    current stream of ``device``; raises if the launch failed."""
    lib = load_library(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, fn)(*args, stream)
    if code != 0:
        message = getattr(lib, LIBRARIES[name].error_string)(code).decode()
        raise RuntimeError(f"{fn} launch failed: {message}")
