"""Device selection for the port's entry points."""

import typing as T

import torch


def resolve_device(device: T.Union[str, torch.device]) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device when none is present.

    Entry points default to ``device="cuda"``; the CPU runs only when the
    caller asks for it. There is no silent fallback from one to the other.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return device
