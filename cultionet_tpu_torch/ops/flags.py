"""Runtime switches for kernel dispatch (counterparts of the Pallas
neighborhood-attention and temporal-attention switches in
cultionet_tpu/ops/flags.py, and of the fused NA block's kernel)."""

_USE_CUDA_NATTEN = True
_USE_CUDA_TEMPORAL = True
_USE_CUDA_NA_BLOCK = True


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
