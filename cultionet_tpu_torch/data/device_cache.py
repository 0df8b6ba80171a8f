"""The device-resident train split (port of
cultionet_tpu/data/device_cache.py).

The packed int16 train split is uploaded to the device once; each batch is
then a row gather on the device (``gather_batch``) from a (B,) index
vector, and the train step dequantizes, augments and normalizes it. An
epoch's index table goes to the device in one copy when the epoch starts.
The chips are packed by the chipstore's rule (``chipstore.quantize``), so
the resident split holds the records a version-2 chipstore file holds.
The JAX cache scales every float field by 10000, which wraps float x
already on the x 10000 scale (v1 reference chips read so); for chips of
floats in [0, 1] (as the chip creator writes them) and for int16 chips
both give the same records.

- ``estimate_cache_bytes``: the resident bytes of a split.
- ``hbm_budget_bytes``: the share of device memory the split may take.
- ``DeviceChipCache``: the resident arrays and the per-epoch shuffled
  index batches (``IndexBatch``), in the JAX package's order.
- ``gather_batch``: the batch of x, y and bdist rows at the indices.

Data parallel, as JAX's mesh does it (arrays replicated, indices
sharded): each rank that ``fit`` launches holds the whole split and
gathers its block of every index batch (``parallel/mesh.py::
shard_batch``).
"""

import typing as T

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.profiling import to_device
from .batch import Batch
from .chipstore import quantize

Tensor = torch.Tensor


class IndexBatch:
    """One step's handle from ``DeviceChipCache``'s epoch iterator: the (B,)
    chip indices to gather, on the cache's device, and ``num_samples`` for
    the fit loop's bookkeeping."""

    __slots__ = ("indices", "num_samples")

    def __init__(self, indices: Tensor):
        self.indices = indices
        self.num_samples = int(indices.shape[0])


def estimate_cache_bytes(
    num_chips: int, in_time: int, height: int, width: int, channels: int
) -> int:
    """int16 x + int16 y + int16 bdist resident bytes."""
    per_chip = (
        in_time * height * width * channels * 2  # x int16
        + height * width * 2  # y int16
        + height * width * 2  # bdist int16
    )
    return num_chips * per_chip


def hbm_budget_bytes(
    fraction: float = 0.5, device: T.Union[str, torch.device] = "cuda"
) -> int:
    """``fraction`` of the card's memory for the resident split (the rest
    stays free for parameters, activations and the optimizer); on the CPU,
    ``fraction`` of 16 GB, the JAX package's figure where a device reports
    no memory size."""
    device = resolve_device(device)
    if device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
        return int(total * fraction)
    return int(16e9 * fraction)


class DeviceChipCache:
    """A ChipDataset's chips as (N, ...) int16 arrays resident on
    ``device``, and per-epoch shuffled (B,) index batches to gather them
    by.

    Epoch ``e`` (from 0) draws ``np.random.default_rng(seed +
    e).permutation(N)``, as the JAX cache does; with ``drop_remainder``
    the last partial batch is dropped, else it is filled by wrapping to the
    permutation's start. ``skip_epochs`` advances the count, so a resumed
    fit sees the epochs an uninterrupted one would.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        seed: int = 42,
        drop_remainder: bool = True,
        device: T.Union[str, torch.device] = "cuda",
    ):
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.drop_remainder = drop_remainder
        self.device = resolve_device(device)
        self._epoch = 0

        xs, ys, bs = [], [], []
        for f in dataset.files:
            chip = Batch.from_file(f)
            xs.append(quantize(chip.x[0].numpy()))
            ys.append(
                None if chip.y is None else chip.y[0].numpy().astype(np.int16)
            )
            bs.append(
                None
                if chip.bdist is None
                else quantize(chip.bdist[0].numpy())
            )

        self.num_chips = len(xs)
        host = {
            "x": np.stack(xs),
            "y": np.stack(ys) if ys[0] is not None else None,
            "bdist": np.stack(bs) if bs[0] is not None else None,
        }
        self.resident_bytes = sum(
            a.nbytes for a in host.values() if a is not None
        )
        self.arrays: T.Dict[str, T.Optional[Tensor]] = {
            name: None if value is None else to_device(torch.from_numpy(value), self.device)
            for name, value in host.items()
        }

    @classmethod
    def fits(
        cls,
        dataset,
        budget_bytes: T.Optional[int] = None,
        device: T.Union[str, torch.device] = "cuda",
    ) -> bool:
        """Whether the split fits ``budget_bytes`` (default:
        ``hbm_budget_bytes`` of ``device``), estimated from the first
        chip's shape alone."""
        if not len(dataset.files):
            return False
        chip = Batch.from_file(dataset.files[0])
        t, h, w, c = chip.x.shape[1:]
        need = estimate_cache_bytes(len(dataset.files), t, h, w, c)
        budget = (
            hbm_budget_bytes(device=device)
            if budget_bytes is None
            else budget_bytes
        )
        return need <= budget

    def __len__(self) -> int:
        if self.drop_remainder:
            return self.num_chips // self.batch_size
        return int(np.ceil(self.num_chips / self.batch_size))

    def skip_epochs(self, epochs: int) -> None:
        self._epoch += epochs

    def _next_epoch_indices(self) -> np.ndarray:
        """The next epoch's (len(self), B) index table; advances the epoch
        count."""
        rng = np.random.default_rng(self.seed + self._epoch)
        self._epoch += 1
        perm = rng.permutation(self.num_chips).astype(np.int32)
        rows = []
        for i in range(len(self)):
            idx = perm[i * self.batch_size : (i + 1) * self.batch_size]
            if len(idx) < self.batch_size:
                idx = np.concatenate([idx, perm[: self.batch_size - len(idx)]])
            rows.append(idx)
        return np.stack(rows) if rows else np.zeros((0, self.batch_size), np.int32)

    def __iter__(self) -> T.Iterator[IndexBatch]:
        table = torch.from_numpy(self._next_epoch_indices().astype(np.int64))
        for row in to_device(table, self.device):
            yield IndexBatch(row)


def gather_batch(arrays: T.Mapping[str, T.Optional[Tensor]], idx: Tensor) -> Batch:
    """The rows ``idx`` of the resident arrays, on their device."""

    def rows(name):
        value = arrays.get(name)
        return None if value is None else value.index_select(0, idx)

    return Batch(x=rows("x"), y=rows("y"), bdist=rows("bdist"))
