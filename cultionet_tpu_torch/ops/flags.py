"""The port's table of hand-written kernel families: each family's launch
table (``ops/<module>.py::LAUNCHES``, one count per launch) and, where it
has one, its runtime switch (counterparts of the Pallas switches in
cultionet_tpu/ops/flags.py). A new family is added here and nowhere else.
"""

import typing as T

_USE_CUDA_NATTEN = True
_USE_CUDA_TEMPORAL = True
_USE_CUDA_NA_BLOCK = True


def launch_tables() -> T.Tuple[T.Dict[str, int], ...]:
    """Every family's ``LAUNCHES`` dict, the one its launches count in, in
    kernel order: NA #1-#4, temporal attention #5-#6 and the fused NA block
    #7, each with a switch below, and LayerNorm #8, which has none. The
    modules are imported here, not when this one is."""
    from . import layer_norm_cuda, na_block_cuda, natten_cuda, temporal_cuda

    return (natten_cuda.LAUNCHES, temporal_cuda.LAUNCHES,
            na_block_cuda.LAUNCHES, layer_norm_cuda.LAUNCHES)


def kernels_on() -> bool:
    """Whether every switch is on (the default)."""
    return _USE_CUDA_NATTEN and _USE_CUDA_TEMPORAL and _USE_CUDA_NA_BLOCK


def set_cuda_natten(enabled: bool) -> None:
    """Send neighborhood attention on CUDA tensors to the hand-written kernel
    (True, the default) or to its plain PyTorch version (False).

    Only an explicit call turns the kernel off; nothing falls back to the
    plain version on its own.
    """
    global _USE_CUDA_NATTEN
    _USE_CUDA_NATTEN = bool(enabled)


def cuda_natten_enabled() -> bool:
    return _USE_CUDA_NATTEN


def set_cuda_temporal(enabled: bool) -> None:
    """Send temporal attention on CUDA tensors to the hand-written kernels
    (True, the default) or to their plain PyTorch version (False). As with
    ``set_cuda_natten``, only an explicit call turns the kernels off."""
    global _USE_CUDA_TEMPORAL
    _USE_CUDA_TEMPORAL = bool(enabled)


def cuda_temporal_enabled() -> bool:
    return _USE_CUDA_TEMPORAL


def set_cuda_na_block(enabled: bool) -> None:
    """Send the fused NA block (``ops/na_block.py::na_block``) on CUDA
    tensors to its hand-written kernel (True, the default) or to its plain
    PyTorch version (False). As with ``set_cuda_natten``, only an explicit
    call turns the kernel off."""
    global _USE_CUDA_NA_BLOCK
    _USE_CUDA_NA_BLOCK = bool(enabled)


def cuda_na_block_enabled() -> bool:
    return _USE_CUDA_NA_BLOCK
