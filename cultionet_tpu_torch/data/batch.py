"""The batch container (port of cultionet_tpu/data/batch.py::Batch).

Tensor layout as in the JAX package: ``x`` is channel-last ``(B, T, H, W,
C)``; labels and distances are ``(B, H, W)``; geographic bounds, lat/lon
and prediction-window geometry are ``(B,)``. ``batch_id`` holds the chips'
file names. Chips are ``.npz`` files with one array per field, the JAX
package's layout (``Batch.to_file`` / ``Batch.from_file``), so a chip
written by either package reads back identically in the other.

Not ported: the reader of reference joblib ``.pt`` chips
(``from_reference_file``), ``to_dataset`` (xarray) and ``plot_batch``.
"""

import dataclasses
import typing as T
from pathlib import Path

import numpy as np
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
    """One (mini)batch of chips.

    ``x`` (B, T, H, W, C) float or int16 x 10000 records; ``y`` (B, H, W)
    integer labels (-1 unlabeled, 0 background, crop classes, the edge
    class); ``bdist`` (B, H, W) boundary distance, float or int16 x 10000;
    the rest (B,) per chip, and ``batch_id`` the chips' names."""

    x: Tensor
    y: T.Optional[Tensor] = None
    bdist: T.Optional[Tensor] = None
    lat: T.Optional[Tensor] = None
    lon: T.Optional[Tensor] = None
    left: T.Optional[Tensor] = None
    bottom: T.Optional[Tensor] = None
    right: T.Optional[Tensor] = None
    top: T.Optional[Tensor] = None
    window_row_off: T.Optional[Tensor] = None
    window_col_off: T.Optional[Tensor] = None
    window_height: T.Optional[Tensor] = None
    window_width: T.Optional[Tensor] = None
    window_pad_bottom: T.Optional[Tensor] = None
    window_pad_right: T.Optional[Tensor] = None
    batch_id: T.Optional[T.Tuple[str, ...]] = None

    _META_KEYS = (
        "left",
        "bottom",
        "right",
        "top",
        "window_row_off",
        "window_col_off",
        "window_height",
        "window_width",
        "window_pad_bottom",
        "window_pad_right",
    )

    def replace(self, **changes) -> "Batch":
        return dataclasses.replace(self, **changes)

    def tensors(self) -> T.Dict[str, Tensor]:
        """The fields that hold a tensor, by name."""
        return {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), Tensor)
        }

    def to(self, device: T.Union[str, torch.device]) -> "Batch":
        """The batch with every tensor on ``device`` (copied without
        waiting when the source is pinned host memory)."""
        return self.replace(
            **{
                name: value.to(device, non_blocking=True)
                for name, value in self.tensors().items()
            }
        )

    def pin_memory(self) -> "Batch":
        """The batch with every tensor in page-locked host memory, so that
        ``to(cuda)`` copies asynchronously."""
        return self.replace(
            **{name: value.pin_memory() for name, value in self.tensors().items()}
        )

    @property
    def num_samples(self) -> int:
        return self.x.shape[0]

    @property
    def num_time(self) -> int:
        return self.x.shape[1]

    @property
    def num_channels(self) -> int:
        return self.x.shape[-1]

    @property
    def height(self) -> int:
        return self.x.shape[2]

    @property
    def width(self) -> int:
        return self.x.shape[3]

    @property
    def is_packed(self) -> bool:
        """True when x carries int16 x 10000 records."""
        return not self.x.is_floating_point()

    def with_centroids(self) -> "Batch":
        """Fill lat/lon from the centroids of the geo bounds."""
        if self.left is None:
            return self
        return self.replace(
            lon=(self.left + self.right) / 2.0,
            lat=(self.bottom + self.top) / 2.0,
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

    # -- files ----------------------------------------------------------

    def to_file(
        self, path: T.Union[str, Path], compression: str = "zlib"
    ) -> None:
        """Write one ``.npz`` array per field (host tensors), and
        ``batch_id`` as an array of strings; ``compression="none"`` writes
        it uncompressed."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        payload = {
            name: value.numpy() for name, value in self.tensors().items()
        }
        if self.batch_id is not None:
            payload["batch_id"] = np.asarray(list(self.batch_id))
        save = np.savez if compression == "none" else np.savez_compressed
        save(path, **payload)

    @classmethod
    def from_file(cls, path: T.Union[str, Path]) -> "Batch":
        """Read an ``.npz`` chip into host tensors, in the stored types."""
        path = Path(path)
        if path.suffix == ".pt":
            raise NotImplementedError(
                "reference joblib .pt chips are not ported yet; convert "
                "them to .npz chips with the JAX package"
            )
        with np.load(path, allow_pickle=False) as data:
            kwargs = {}
            for name in data.files:
                if name == "batch_id":
                    kwargs[name] = tuple(str(s) for s in data[name])
                else:
                    kwargs[name] = torch.from_numpy(np.array(data[name]))
        return cls(**kwargs)

    @classmethod
    def read_meta(cls, path: T.Union[str, Path]) -> "Batch":
        """Geo bounds, window geometry and ``batch_id`` only; ``x`` is an
        empty (n, 0) placeholder. The large arrays are never decompressed
        (npz members load lazily)."""
        path = Path(path)
        if path.suffix == ".pt":
            raise NotImplementedError(
                "reference joblib .pt chips are not ported yet"
            )
        with np.load(path, allow_pickle=False) as data:
            kwargs = {
                name: torch.from_numpy(np.array(data[name]))
                for name in data.files
                if name in cls._META_KEYS
            }
            n = 1
            for key in cls._META_KEYS:
                if key in kwargs:
                    n = int(np.atleast_1d(kwargs[key].numpy()).shape[0])
                    break
            batch_id = None
            if "batch_id" in data.files:
                batch_id = tuple(str(s) for s in data["batch_id"])
        return cls(x=torch.zeros((n, 0)), batch_id=batch_id, **kwargs)


def collate(batches: T.Sequence[Batch]) -> Batch:
    """Concatenate the chips field by field along the batch axis; the
    ``batch_id``s join in order."""
    first = batches[0]
    fields = {}
    for f in dataclasses.fields(first):
        value = getattr(first, f.name)
        if f.name == "batch_id":
            ids = [b.batch_id for b in batches if b.batch_id is not None]
            fields[f.name] = tuple(s for group in ids for s in group) or None
        elif value is None:
            fields[f.name] = None
        else:
            fields[f.name] = torch.cat([getattr(b, f.name) for b in batches])
    return Batch(**fields)
