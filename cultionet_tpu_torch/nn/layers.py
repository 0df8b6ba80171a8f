"""Layers that promote their input and weights to one type, as flax's do.

A flax layer computes in ``jnp.promote_types`` of its input and its
parameters: an fp32 input meets bf16 weights in fp32. torch's layers
raise on the mix instead. The JAX model meets it under ``use_latlon``
with a bf16 compute type: the step casts only ``x`` to bf16, so the fp32
lat/lon embedding makes the fusion towers and the heads fp32
(``models/unet_parts.py::TowerUNetBlock``). These layers mirror that:
where the input's type and the weights' differ, both are cast to the
promoted type at use (a bf16 -> fp32 cast is exact); where they agree,
the layer is torch's own.
"""

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor


def promoted(x: Tensor, weight: Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, weight.dtype)


def cast(tensor, dtype: torch.dtype):
    return None if tensor is None else tensor.to(dtype)


class Conv2d(nn.Conv2d):
    def forward(self, x: Tensor) -> Tensor:
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        dtype = promoted(x, self.weight)
        return self._conv_forward(
            x.to(dtype), self.weight.to(dtype), cast(self.bias, dtype)
        )


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x: Tensor) -> Tensor:
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        dtype = promoted(x, self.weight)
        return F.conv_transpose2d(
            x.to(dtype),
            self.weight.to(dtype),
            cast(self.bias, dtype),
            self.stride,
            self.padding,
            self.output_padding,
            self.groups,
            self.dilation,
        )


class Linear(nn.Linear):
    def forward(self, x: Tensor) -> Tensor:
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        dtype = promoted(x, self.weight)
        return F.linear(x.to(dtype), self.weight.to(dtype), cast(self.bias, dtype))
