"""The batch container (port of cultionet_tpu/data/batch.py::Batch).

Tensor layout as in the JAX package: ``x`` is channel-last ``(B, T, H, W,
C)``; labels and distances are ``(B, H, W)``; geographic bounds, lat/lon
and prediction-window geometry are ``(B,)``. ``batch_id`` holds the chips'
file names. A chip of a dated series (U-TAE's) carries ``dates`` (B, T),
the acquisition days, and ``date_count`` (B,), how many of its T dates
are real (the first ones; the rest are zero padding). Such chips may
differ in T: ``collate`` pads them to the batch's longest. Chips are
``.npz`` files with one array per field, the JAX package's layout (``Batch.to_file`` / ``Batch.from_file``), so a chip
written by either package reads back identically in the other.
``from_file`` also reads the reference framework's joblib ``.pt`` chips
(``from_reference_file``): its (B, C, T, H, W) dict chips and its v1-era
pickled torch_geometric graphs, the latter through an import shim, so
torch_geometric need not be installed; ``joblib`` must be.

Not ported: ``to_dataset`` (xarray) and ``plot_batch``.
"""

import dataclasses
import typing as T
from pathlib import Path

import numpy as np
import torch

from ..utils.profiling import to_device
from .constant import SCALE_FACTOR

Tensor = torch.Tensor

_SHIM_INSTALLED = False


def _install_torch_geometric_shim() -> None:
    """Register a permissive import shim, so that v1-era reference chips
    (pickled torch_geometric Data objects) unpickle without the package:
    every class of a ``torch_geometric`` module is made up on lookup, and
    its instances keep their pickled state in ``__dict__``."""
    global _SHIM_INSTALLED
    if _SHIM_INSTALLED:
        return
    try:
        import torch_geometric  # noqa: F401

        _SHIM_INSTALLED = True
        return
    except ImportError:
        pass

    import importlib.abc
    import importlib.machinery
    import sys
    import types

    class _ShimLoader(importlib.abc.Loader):
        def create_module(self, spec):
            mod = types.ModuleType(spec.name)
            mod.__path__ = []

            def getattr_(name, _mod=mod):
                if name.startswith("__"):
                    raise AttributeError(name)
                cls = type(
                    name,
                    (),
                    {
                        "__init__": lambda self, *a, **k: self.__dict__.update(
                            k
                        ),
                        "__setstate__": lambda self, st: self.__dict__.update(
                            st if isinstance(st, dict) else {"_state": st}
                        ),
                    },
                )
                setattr(_mod, name, cls)
                return cls

            mod.__getattr__ = getattr_
            return mod

        def exec_module(self, module):
            pass

    class _ShimFinder(importlib.abc.MetaPathFinder):
        def find_spec(self, fullname, path=None, target=None):
            if fullname.split(".")[0] == "torch_geometric":
                return importlib.machinery.ModuleSpec(
                    fullname, _ShimLoader(), is_package=True
                )
            return None

    sys.meta_path.insert(0, _ShimFinder())
    _SHIM_INSTALLED = True


def _extract_pyg_store(obj) -> T.Optional[dict]:
    """The tensor mapping inside an unpickled torch_geometric Data."""
    store = getattr(obj, "_store", None)
    if store is None:
        return None
    for value in store.__dict__.values():
        if isinstance(value, dict) and "x" in value:
            return value
    return None


def _host_tensor(value) -> Tensor:
    """A host tensor of ``value`` in the type the JAX reader's arrays take:
    64-bit integers and floats narrowed to 32 bits."""
    array = np.asarray(value)
    narrow = {np.dtype("int64"): np.int32, np.dtype("uint64"): np.uint32,
              np.dtype("float64"): np.float32}
    if array.dtype in narrow:
        array = array.astype(narrow[array.dtype])
    return torch.from_numpy(np.ascontiguousarray(array))


def dequantize(x: Tensor, dtype: torch.dtype = torch.float32) -> Tensor:
    """Unpack int16 x 10000 records to float; a float tensor passes as
    is. The factor is a Python number, so nothing is copied to the device;
    in fp32 and fp64 the product equals the one with a 0-d tensor of the
    factor in that type."""
    if x.is_floating_point():
        return x
    return x.to(dtype) * (1.0 / SCALE_FACTOR)


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
    dates: T.Optional[Tensor] = None
    date_count: T.Optional[Tensor] = None
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
                name: to_device(value, device, non_blocking=True)
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
        """Read an ``.npz`` chip into host tensors, in the stored types; a
        ``.pt`` chip goes through ``from_reference_file``."""
        path = Path(path)
        if path.suffix == ".pt":
            return cls.from_reference_file(path)
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
        empty (n, 0) placeholder. The large arrays of an ``.npz`` chip are
        never decompressed (npz members load lazily); a ``.pt`` chip is
        read whole (a joblib file is one blob)."""
        path = Path(path)
        if path.suffix == ".pt":
            full = cls.from_reference_file(path)
            return cls(
                x=torch.zeros((full.num_samples, 0)),
                **{k: getattr(full, k) for k in cls._META_KEYS},
                batch_id=full.batch_id,
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

    @classmethod
    def from_reference_file(cls, path: T.Union[str, Path]) -> "Batch":
        """Read a reference-framework joblib ``.pt`` chip: the dict format
        (``from_reference_dict``) or a v1-era torch_geometric graph
        (``from_reference_pyg``, through the import shim). Raises
        ``ImportError`` when ``joblib`` is missing. joblib unpickles the
        file, which can run code: read chips from sources you trust."""
        try:
            import joblib
        except ImportError as err:
            raise ImportError(
                "reading reference .pt chips needs joblib, which is not "
                "installed"
            ) from err

        _install_torch_geometric_shim()
        stored = joblib.load(path)
        if not isinstance(stored, T.Mapping):
            stored = _extract_pyg_store(stored)
            if stored is None:
                raise ValueError(f"Unrecognized reference chip format: {path}")
            return cls.from_reference_pyg(stored, batch_id=(Path(path).name,))
        return cls.from_reference_dict(stored, batch_id=(Path(path).name,))

    @classmethod
    def from_reference_pyg(
        cls, store: T.Mapping, batch_id: T.Optional[T.Tuple[str, ...]] = None
    ) -> "Batch":
        """A v1 node-format chip: x (H*W, C*T) in band-major columns, y and
        bdist (H*W,), to the (1, T, H, W, C) layout."""
        height = int(store["height"])
        width = int(store["width"])
        ntime = int(store["ntime"])
        nbands = int(store["nbands"])

        x = np.asarray(store["x"], dtype="float32")
        if x.shape != (height * width, ntime * nbands):
            raise ValueError(f"Unexpected node-feature shape {x.shape}")
        # Columns are (band, time) blocks: (hw, c*t) -> (t, h, w, c).
        x = x.reshape(height, width, nbands, ntime)
        x = np.transpose(x, (3, 0, 1, 2))[None]

        def img(key):
            if store.get(key) is None:
                return None
            return _host_tensor(np.asarray(store[key]).reshape(1, height, width))

        def scalar(key):
            if key not in store:
                return None
            return torch.from_numpy(np.asarray([np.float32(store[key])]))

        return cls(
            x=_host_tensor(x),
            y=img("y"),
            bdist=img("bdist"),
            left=scalar("left"),
            bottom=scalar("bottom"),
            right=scalar("right"),
            top=scalar("top"),
            batch_id=batch_id,
        )

    @classmethod
    def from_reference_dict(
        cls, stored: T.Mapping, batch_id: T.Optional[T.Tuple[str, ...]] = None
    ) -> "Batch":
        """A dict chip: x (B, C, T, H, W) to (B, T, H, W, C); y, bdist,
        bounds and window geometry as stored (bounds as float32 (B,))."""

        def grab(key):
            value = stored.get(key)
            return None if value is None else np.asarray(value)

        x = grab("x")
        if x is None:
            raise ValueError("Reference chip has no 'x' tensor")

        def arr(key):
            value = grab(key)
            return None if value is None else _host_tensor(value)

        def scalar(key):
            value = grab(key)
            if value is None:
                return None
            return torch.from_numpy(
                np.atleast_1d(np.asarray(value, dtype=np.float32))
            )

        stored_id = stored.get("batch_id")
        if batch_id is None and stored_id is not None:
            batch_id = tuple(str(s) for s in stored_id)

        return cls(
            x=_host_tensor(np.transpose(x, (0, 2, 3, 4, 1))),
            y=arr("y"),
            bdist=arr("bdist"),
            left=scalar("left"),
            bottom=scalar("bottom"),
            right=scalar("right"),
            top=scalar("top"),
            window_row_off=arr("window_row_off"),
            window_col_off=arr("window_col_off"),
            window_height=arr("window_height"),
            window_width=arr("window_width"),
            window_pad_bottom=arr("window_pad_bottom"),
            window_pad_right=arr("window_pad_right"),
            batch_id=batch_id,
        )


def collate(batches: T.Sequence[Batch]) -> Batch:
    """Concatenate the chips field by field along the batch axis; the
    ``batch_id``s join in order. Dated chips of different T are padded
    with zeros to the longest (``pad_dates``)."""
    if batches[0].dates is not None:
        steps = max(b.num_time for b in batches)
        batches = [pad_dates(b, steps) for b in batches]
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


def pad_dates(batch: Batch, steps: int) -> Batch:
    """A dated batch with ``x`` and ``dates`` zero-padded along T to
    ``steps`` dates; ``date_count`` keeps the real ones."""
    extra = steps - batch.num_time
    if extra < 0:
        raise ValueError(f"the batch has {batch.num_time} dates, more than {steps}")
    if extra == 0:
        return batch
    x = torch.nn.functional.pad(batch.x, (0, 0, 0, 0, 0, 0, 0, extra))
    dates = torch.nn.functional.pad(batch.dates, (0, extra))
    return batch.replace(x=x, dates=dates)


def count_date_images(date_count: np.ndarray, steps: int) -> None:
    """Count a batch's date images, ``utae_date_images`` (chips x T), and
    the padding among them, ``utae_pad_images`` (``utils/profiling.py``)."""
    from ..utils.profiling import add_count

    date_count = np.asarray(date_count)
    total = int(date_count.size) * int(steps)
    add_count("utae_date_images", total)
    add_count("utae_pad_images", total - int(date_count.sum()))
