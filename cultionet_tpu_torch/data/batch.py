"""The training batch (port of the part of cultionet_tpu/data/batch.py::Batch
that the train and eval steps read: ``x``, ``y``, ``bdist`` and
``dequantize``). The geographic fields, file I/O and collation come with
the data pipeline."""

import dataclasses
import typing as T

import torch

from .constant import SCALE_FACTOR

Tensor = torch.Tensor


def dequantize(x: Tensor, dtype: torch.dtype = torch.float32) -> Tensor:
    """Unpack int16 x 10000 records to float; a float tensor passes as
    is."""
    if x.is_floating_point():
        return x
    return x.to(dtype) * torch.tensor(
        1.0 / SCALE_FACTOR, dtype=dtype, device=x.device
    )


@dataclasses.dataclass(frozen=True)
class Batch:
    """``x`` (B, T, H, W, C) float or int16 x 10000 records; ``y`` (B, H, W)
    integer labels (-1 unlabeled, 0 background, crop classes, the edge
    class); ``bdist`` (B, H, W) boundary distance, float or int16 x 10000."""

    x: Tensor
    y: T.Optional[Tensor] = None
    bdist: T.Optional[Tensor] = None

    def replace(self, **changes) -> "Batch":
        return dataclasses.replace(self, **changes)

    def to(self, device: T.Union[str, torch.device]) -> "Batch":
        """The batch with every tensor on ``device``."""
        return self.replace(
            **{
                f.name: None
                if getattr(self, f.name) is None
                else getattr(self, f.name).to(device, non_blocking=True)
                for f in dataclasses.fields(self)
            }
        )

    def dequantize(self, dtype: torch.dtype = torch.float32) -> "Batch":
        """Unpack int16 x 10000 ``x`` and ``bdist`` to ``dtype`` and cast
        ``y`` to int32, on the tensors' device; float fields pass as they
        are."""
        bdist = self.bdist
        return self.replace(
            x=dequantize(self.x, dtype),
            bdist=None if bdist is None else dequantize(bdist, dtype),
            y=None if self.y is None else self.y.to(torch.int32),
        )
