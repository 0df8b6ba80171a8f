"""Runtime switch for kernel dispatch (counterpart of the Pallas
neighborhood-attention switch in cultionet_tpu/ops/flags.py)."""

_USE_CUDA_NATTEN = True


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
