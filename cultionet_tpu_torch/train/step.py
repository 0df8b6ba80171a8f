"""The predict half of the step module (port of
cultionet_tpu/train/step.py::_inference_apply / make_predict_step).

Losses, the train and eval steps come with the training slice.
"""

import copy
import typing as T

import torch
from torch import nn

from ..data.constant import SCALE_FACTOR
from ..utils.device import resolve_device
from .precision import resolve_dtype

Tensor = torch.Tensor


def dequantize(x: Tensor, dtype: torch.dtype = torch.float32) -> Tensor:
    """Unpack int16 x 10000 records to float; a float ``x`` passes as is."""
    if x.is_floating_point():
        return x
    return x.to(dtype) * torch.tensor(
        1.0 / SCALE_FACTOR, dtype=dtype, device=x.device
    )


def _inference_apply(
    model: nn.Module, x: Tensor, compute_dtype: torch.dtype
) -> T.Dict[str, T.Optional[Tensor]]:
    """Dequantize, run ``model`` (already in ``compute_dtype``) on ``x`` in
    the compute dtype, and return fp32 outputs."""
    outputs = model(dequantize(x).to(compute_dtype))
    return {
        name: None if value is None else value.float()
        for name, value in outputs.items()
    }


def make_predict_step(
    model: nn.Module, precision: str = "fp32", device="cuda"
) -> T.Callable[[Tensor], T.Dict[str, T.Optional[Tensor]]]:
    """A predict step bound to an eval copy of ``model`` whose parameters
    and buffers are cast to the compute dtype once, on ``device`` (JAX casts
    them inside every step; the weights do not change while predicting).
    The step takes ``x`` (B, T, H, W, C), int16-packed or float, moves it to
    the device and runs under ``torch.inference_mode``."""
    device = resolve_device(device)
    compute_dtype = resolve_dtype(precision)
    run_model = copy.deepcopy(model).to(device=device, dtype=compute_dtype)
    run_model.eval()

    def predict_step(x: Tensor) -> T.Dict[str, T.Optional[Tensor]]:
        with torch.inference_mode():
            return _inference_apply(
                run_model, torch.as_tensor(x).to(device), compute_dtype
            )

    return predict_step
