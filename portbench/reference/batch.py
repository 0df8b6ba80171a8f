"""The chip batch the copied augmenters transform: x (B, T, H, W, C),
y and bdist (B, H, W), on the host."""

import dataclasses
import typing as T

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Batch:
    x: Tensor
    y: T.Optional[Tensor] = None
    bdist: T.Optional[Tensor] = None

    def replace(self, **changes) -> "Batch":
        return dataclasses.replace(self, **changes)

    @property
    def num_time(self) -> int:
        return self.x.shape[1]

    @property
    def height(self) -> int:
        return self.x.shape[2]

    @property
    def width(self) -> int:
        return self.x.shape[3]
