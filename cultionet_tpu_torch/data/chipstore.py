"""The chipstore: chips packed into one binary file, read by a native
multithreaded batch loader (port of cultionet_tpu/data/chipstore.py).

The file layout and the loader are ``native/chipstore.cpp`` (the port's
copy of the JAX package's source), bound with ``ctypes``. At first use
``g++`` builds it into ``cultionet_tpu_torch/_build/`` under a name that
carries the hash of the source; nothing here runs at import.

- ``write_chipstore``: pack single-chip ``Batch``es into one file, float32
  records (version 1) or int16 x 10000 records (version 2).
- ``ChipStore``: the mmap'd reader; ``read_batch`` of explicit indices,
  and ``iter_prefetched``, shuffled batches that C++ worker threads
  assemble into a ring of slots.
- ``build_chipstore_from_dataset``: a ``ChipDataset``'s raw chips packed
  once, under a name keyed on the membership.
- ``ChipstoreLoader``: the train loader of ``fit(use_chipstore="stream")``,
  an epoch of raw int16 batches on the fit's device; the train step
  dequantizes, augments and normalizes them.

Batches hold host tensors (``read_batch``, ``iter_prefetched``) or tensors
on the loader's device (``ChipstoreLoader``).
"""

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import tempfile
import threading
import typing as T
from pathlib import Path

import numpy as np
import torch

from ..utils.profiling import to_device
from .batch import Batch
from .constant import SCALE_FACTOR

_MAGIC = b"CTS1"
_VERSION = 1
_VERSION_PACKED = 2
_META_FLOATS = 8

SOURCE = Path(__file__).resolve().parents[1] / "native" / "chipstore.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lib: T.Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libchipstore_{digest}.so"


def build_library() -> Path:
    """Compile ``native/chipstore.cpp`` with ``g++`` unless the library of
    this source exists; returns its path. Raises when ``g++`` is missing or
    fails."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(
            "g++ not found on PATH; the chipstore library "
            f"({SOURCE.name}) cannot be built"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [gxx, *GXX_FLAGS, str(SOURCE), "-o", tmp],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed to build {SOURCE.name} ({proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the chipstore library once per process."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_library()))
        c_void_p, c_int64 = ctypes.c_void_p, ctypes.c_int64
        signatures = {
            "cs_open": (c_void_p, [ctypes.c_char_p]),
            "cs_num_chips": (c_int64, [c_void_p]),
            "cs_dims": (None, [c_void_p, ctypes.POINTER(ctypes.c_uint32)]),
            "cs_version": (ctypes.c_uint32, [c_void_p]),
            "cs_read_batch": (
                ctypes.c_int,
                [c_void_p, ctypes.POINTER(c_int64), c_int64]
                + [c_void_p] * 4,
            ),
            "cs_prefetch_start_block": (
                ctypes.c_int,
                [c_void_p, c_int64, c_int64, c_int64, ctypes.c_uint64,
                 ctypes.c_int, ctypes.c_int],
            ),
            "cs_next_slot": (c_int64, [c_void_p, ctypes.POINTER(c_int64)]),
            "cs_slot_ptrs": (
                None, [c_void_p, c_int64, ctypes.POINTER(c_void_p)]
            ),
            "cs_release_slot": (None, [c_void_p, c_int64]),
            "cs_prefetch_stop": (None, [c_void_p]),
            "cs_close": (None, [c_void_p]),
        }
        for name, (restype, argtypes) in signatures.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
        return lib


def quantize(arr) -> np.ndarray:
    """int16 x 10000 records of a chip field: integers as they are; floats
    above 2 taken as already packed (float-typed x 10000 values, as v1
    reference chips read) and rounded; else scaled by 10000 and rounded;
    clipped to the int16 range."""
    arr = np.asarray(arr)
    if np.issubdtype(arr.dtype, np.integer):
        return np.ascontiguousarray(arr, dtype="<i2")
    if arr.size and float(np.abs(arr).max()) > 2.0:
        return np.round(np.clip(arr, -32768, 32767)).astype("<i2")
    return np.round(np.clip(arr * SCALE_FACTOR, -32768, 32767)).astype("<i2")


def write_chipstore(
    path: T.Union[str, Path],
    batches: T.Iterable[Batch],
    packed: bool = False,
) -> Path:
    """Pack single-chip Batches (host tensors or numpy arrays) into one
    chipstore file; the JAX package's ``write_chipstore`` of the same chips
    writes the same bytes.

    ``packed=True`` writes version-2 records: x and bdist as int16 x 10000
    and y as int16, half the bytes of version 1's float32 (and int32 y).
    The meta floats are each chip's left, bottom, right, top and the
    centroid's lat and lon.
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)

    chips = list(batches)
    if not chips:
        raise ValueError("No chips to write")
    _, t, h, w, c = chips[0].x.shape
    has_labels = chips[0].y is not None

    with open(path, "wb") as dst:
        dst.write(
            struct.pack(
                "<4sIQIIIIII",
                _MAGIC,
                _VERSION_PACKED if packed else _VERSION,
                len(chips),
                t,
                h,
                w,
                c,
                1 if has_labels else 0,
                0,
            )
        )
        for chip in chips:
            if tuple(chip.x.shape) != (1, t, h, w, c):
                raise ValueError(
                    f"chip shape {tuple(chip.x.shape)} differs from the "
                    f"first chip's {(1, t, h, w, c)}"
                )
            x = np.asarray(chip.x[0])
            if packed:
                dst.write(quantize(x).tobytes())
            else:
                dst.write(np.ascontiguousarray(x, dtype="<f4").tobytes())
            if has_labels:
                y, bdist = np.asarray(chip.y[0]), np.asarray(chip.bdist[0])
                if packed:
                    dst.write(np.ascontiguousarray(y, dtype="<i2").tobytes())
                    dst.write(quantize(bdist).tobytes())
                else:
                    dst.write(np.ascontiguousarray(y, dtype="<i4").tobytes())
                    dst.write(
                        np.ascontiguousarray(bdist, dtype="<f4").tobytes()
                    )
            meta = np.zeros(_META_FLOATS, dtype="<f4")
            for i, name in enumerate(("left", "bottom", "right", "top")):
                value = getattr(chip, name)
                if value is not None:
                    meta[i] = float(np.asarray(value)[0])
            meta[4] = (meta[1] + meta[3]) / 2.0  # lat
            meta[5] = (meta[0] + meta[2]) / 2.0  # lon
            dst.write(meta.tobytes())
    return path


class ChipStore:
    """mmap'd chipstore reader."""

    def __init__(self, path: T.Union[str, Path]):
        self.lib = load_library()
        self.handle = self.lib.cs_open(str(path).encode())
        if not self.handle:
            raise IOError(f"Cannot open chipstore {path}")
        dims = (ctypes.c_uint32 * 5)()
        self.lib.cs_dims(self.handle, dims)
        self.t, self.h, self.w, self.c, has_labels = (int(d) for d in dims)
        self.has_labels = bool(has_labels)
        self.num_chips = int(self.lib.cs_num_chips(self.handle))
        self.version = int(self.lib.cs_version(self.handle))
        self.packed = self.version == _VERSION_PACKED
        # Per-field record types (native/chipstore.cpp's header comment).
        self.x_dtype = np.int16 if self.packed else np.float32
        self.y_dtype = np.int16 if self.packed else np.int32
        self.bdist_dtype = np.int16 if self.packed else np.float32

    def __len__(self) -> int:
        return self.num_chips

    def _shapes(self, n: int) -> T.Dict[str, T.Tuple[tuple, T.Any]]:
        """Each field's (shape, dtype) for ``n`` chips; y and bdist only
        with labels."""
        shapes = {"x": ((n, self.t, self.h, self.w, self.c), self.x_dtype)}
        if self.has_labels:
            shapes["y"] = ((n, self.h, self.w), self.y_dtype)
            shapes["bdist"] = ((n, self.h, self.w), self.bdist_dtype)
        shapes["meta"] = ((n, _META_FLOATS), np.float32)
        return shapes

    @staticmethod
    def _to_batch(fields: T.Dict[str, torch.Tensor], n: int) -> Batch:
        """A Batch of the first ``n`` chips of the field tensors (x, y,
        bdist, meta); lat, lon and the bounds are views of meta."""
        meta = fields["meta"][:n]
        y, bdist = fields.get("y"), fields.get("bdist")
        return Batch(
            x=fields["x"][:n],
            y=None if y is None else y[:n],
            bdist=None if bdist is None else bdist[:n],
            left=meta[:, 0],
            bottom=meta[:, 1],
            right=meta[:, 2],
            top=meta[:, 3],
            lat=meta[:, 4],
            lon=meta[:, 5],
        )

    def read_batch(self, indices: T.Sequence[int]) -> Batch:
        """The chips at ``indices``, in the stored types; an index out of
        range raises ``IndexError``."""
        idx = np.ascontiguousarray(np.asarray(indices, dtype="int64"))
        n = int(idx.shape[0])
        fields = {
            name: np.empty(shape, dtype=dtype)
            for name, (shape, dtype) in self._shapes(n).items()
        }

        def ptr(name):
            array = fields.get(name)
            return None if array is None else ctypes.c_void_p(array.ctypes.data)

        rc = self.lib.cs_read_batch(
            self.handle,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n,
            ptr("x"),
            ptr("y"),
            ptr("bdist"),
            ptr("meta"),
        )
        if rc != 0:
            raise IndexError("chip index out of range")
        return self._to_batch(
            {name: torch.from_numpy(value) for name, value in fields.items()}, n
        )

    def iter_prefetched(
        self,
        batch_size: int,
        seed: int = 42,
        num_threads: int = 2,
        max_queue: int = 4,
        num_batches: T.Optional[int] = None,
        copy: bool = True,
    ) -> T.Iterator[Batch]:
        """Shuffled, endlessly reshuffling batches that the native worker
        threads assemble into a ring of ``max_queue`` slots, in the order
        the batches were claimed; ``num_batches`` of them (default: one
        epoch, the full batches of ``len(self)`` chips).

        With ``copy=False`` the yielded tensors share the slot's memory and
        hold only until the next batch is asked for (consume them in the
        loop body); ``copy=True`` (default) gives them their own."""
        for fields, n in self.iter_slots(
            batch_size, seed, num_threads, max_queue, num_batches
        ):
            yield self._to_batch(
                {
                    name: torch.from_numpy(value.copy() if copy else value)
                    for name, value in fields.items()
                },
                n,
            )

    def iter_slots(
        self,
        batch_size: int,
        seed: int,
        num_threads: int,
        max_queue: int,
        num_batches: T.Optional[int] = None,
        block: T.Optional[T.Tuple[int, int]] = None,
    ) -> T.Iterator[T.Tuple[T.Dict[str, np.ndarray], int]]:
        """``iter_prefetched``'s batches as (numpy views of the slot's x, y,
        bdist and meta, chip count); a slot returns to the workers when
        the next batch is asked for. With ``block=(lo, hi)`` a slot holds
        only the rows [lo, hi) of each shuffled batch: the workers read
        no other chip."""
        if num_batches is None:
            num_batches = max(1, self.num_chips // batch_size)
        lo, hi = (0, batch_size) if block is None else block
        rc = self.lib.cs_prefetch_start_block(
            self.handle, batch_size, lo, hi, seed, num_threads, max_queue
        )
        if rc != 0:
            raise RuntimeError(
                f"prefetch already running, or rows [{lo}, {hi}) are not "
                f"a block of a batch of {batch_size}"
            )
        shapes = self._shapes(hi - lo)
        try:
            for _ in range(num_batches):
                count = ctypes.c_int64(0)
                slot = self.lib.cs_next_slot(self.handle, ctypes.byref(count))
                if slot < 0:
                    break
                ptrs = (ctypes.c_void_p * 4)()
                self.lib.cs_slot_ptrs(self.handle, slot, ptrs)
                fields = {}
                for name, address in zip(("x", "y", "bdist", "meta"), ptrs):
                    if name not in shapes:
                        continue
                    shape, dtype = shapes[name]
                    nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
                    buf = (ctypes.c_uint8 * nbytes).from_address(address)
                    fields[name] = np.frombuffer(buf, dtype=dtype).reshape(shape)
                try:
                    yield fields, int(count.value)
                finally:
                    self.lib.cs_release_slot(self.handle, slot)
        finally:
            self.lib.cs_prefetch_stop(self.handle)

    def close(self) -> None:
        if getattr(self, "handle", None):
            self.lib.cs_close(self.handle)
            self.handle = None

    def __enter__(self) -> "ChipStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # pragma: no cover
        self.close()


def build_chipstore_from_dataset(
    dataset,
    path: T.Union[str, Path],
    packed: bool = True,
    process_index: int = 0,
) -> Path:
    """Pack a ChipDataset's raw chips (unscaled and unaugmented: the train
    step dequantizes, augments and normalizes them) into one store file.

    The file is named as the JAX package names it: ``path``'s stem, the
    ``process_index`` (``-p0-``; a process of a group that holds its own
    file stripe passes its rank, so processes sharing a file system never
    write one file) and a sha1 of the format and the sorted chip paths, so
    a new split builds a new store. It is rebuilt when a member chip is
    newer than it.
    """
    path = Path(path)
    files = list(dataset.files)
    key_src = "\n".join(sorted(str(f) for f in files))
    key = hashlib.sha1(
        f"v2|packed={int(packed)}|{key_src}".encode()
    ).hexdigest()[:12]
    path = path.with_name(f"{path.stem}-p{process_index}-{key}{path.suffix}")
    if path.exists() and files:
        newest = max(f.stat().st_mtime for f in files)
        if path.stat().st_mtime >= newest:
            return path
    chips = (Batch.from_file(f) for f in files)
    return write_chipstore(path, chips, packed=packed)


class _PinnedRing:
    """Page-locked host buffers through which slot batches reach the card.

    A batch's fields are copied from the native slot into the next
    buffer (host work, after which the slot can be released) and from
    there to the device without waiting; an event after that copy guards
    the buffer, which is written again only once the event has passed.
    The buffers are allocated at first use and kept."""

    def __init__(self, device: torch.device, depth: int = 3):
        self.device = device
        self.buffers: T.List[T.Dict[str, torch.Tensor]] = [{} for _ in range(depth)]
        self.events: T.List[T.Optional[torch.cuda.Event]] = [None] * depth
        self.turn = 0

    def to_device(self, fields: T.Dict[str, np.ndarray]) -> T.Dict[str, torch.Tensor]:
        k = self.turn
        self.turn = (k + 1) % len(self.buffers)
        if self.events[k] is not None:
            self.events[k].synchronize()
        buffers = self.buffers[k]
        moved = {}
        for name, value in fields.items():
            source = torch.from_numpy(value)
            buffer = buffers.get(name)
            if buffer is None or buffer.shape != source.shape:
                buffer = buffers[name] = torch.empty_like(source).pin_memory()
            buffer.copy_(source)
            moved[name] = to_device(buffer, self.device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        self.events[k] = event
        return moved


class ChipstoreLoader:
    """Epoch-iterable train loader over a packed chipstore: C++ worker
    threads assemble shuffled int16 batches into the slot ring, and each
    batch is delivered on ``device`` raw (the train step dequantizes,
    augments and normalizes it). Epoch ``e`` (from 1) shuffles with seed
    ``seed + e``, as the JAX loader does; ``skip_epochs`` advances the
    count, so a resumed fit sees the epochs an uninterrupted one would.

    On a card the batch goes through page-locked buffers (``_PinnedRing``,
    kept across epochs), so its copy to the device does not wait and the
    slot returns to the workers at once; on the CPU it is copied out of
    the slot.

    With ``shard=(rank, world)`` each batch is that rank's contiguous
    block of the global batch of ``batch_size`` (as
    ``parallel/mesh.py::shard_batch`` cuts it): the workers read and copy
    only those chips. ``process_index`` names the store file
    (``build_chipstore_from_dataset``)."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        cache_path: T.Union[str, Path],
        seed: int = 42,
        num_threads: int = 4,
        device: T.Union[str, torch.device] = "cpu",
        shard: T.Optional[T.Tuple[int, int]] = None,
        process_index: int = 0,
    ):
        self.batch_size = batch_size
        self.seed = seed
        self.num_threads = num_threads
        self.device = torch.device(device)
        self.block = None
        if shard is not None:
            rank, world = shard
            if batch_size % world:
                raise ValueError(
                    f"a batch of {batch_size} does not split over {world} ranks"
                )
            self.block = (rank * batch_size // world,
                          (rank + 1) * batch_size // world)
        self.path = build_chipstore_from_dataset(
            dataset, cache_path, process_index=process_index
        )
        with ChipStore(self.path) as store:
            self.num_chips = len(store)
        self._epoch = 0
        self._ring = (
            _PinnedRing(self.device) if self.device.type == "cuda" else None
        )

    def __len__(self) -> int:
        return max(1, self.num_chips // self.batch_size)

    def skip_epochs(self, epochs: int) -> None:
        self._epoch += epochs

    def __iter__(self) -> T.Iterator[Batch]:
        self._epoch += 1
        with ChipStore(self.path) as store:
            for fields, n in store.iter_slots(
                self.batch_size,
                self.seed + self._epoch,
                self.num_threads,
                max_queue=4,
                num_batches=len(self),
                block=self.block,
            ):
                if self._ring is None:
                    tensors = {
                        name: torch.from_numpy(value.copy())
                        for name, value in fields.items()
                    }
                else:
                    tensors = self._ring.to_device(fields)
                yield ChipStore._to_batch(tensors, n)
