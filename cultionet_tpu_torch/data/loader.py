"""Batched, prefetching chip loading (port of
cultionet_tpu/data/loader.py::ChipLoader).

One background thread reads and collates the chips of the next batches
while the caller trains on the current one. For a CUDA ``device`` the
thread collates into page-locked host memory and starts the host-to-device
copy with ``non_blocking=True``, so the copy overlaps the previous step.

Data-parallel loading: ``shard=(rank, world)`` makes a loader deliver
only its rank's contiguous block of each global batch (every rank draws
the same shuffle), and ``process_local_selection`` is the JAX multi-host
rule of which chip files a process of an externally launched group
loads.
"""

import queue
import threading
import typing as T

import numpy as np
import torch

from .batch import Batch, collate
from .datasets import ChipDataset

_DONE = object()


def process_local_selection(
    num_files: int, process_index: int, process_count: int
) -> np.ndarray:
    """Strided file assignment for multi-process loading: process p takes
    files p, p+P, p+2P, ... so every chip belongs to exactly one process
    and per-process counts differ by at most one."""
    return np.arange(process_index, num_files, process_count)


class ChipLoader:
    """Iterate a ChipDataset in collated batches with background prefetch.

    The batch order is the JAX loader's for the same seed: each pass over
    the loader draws ``rng.permutation`` once when ``shuffle`` is set, from
    ``rng`` (default: a numpy generator seeded with the dataset's
    ``random_seed``). ``device`` is where the batches are delivered
    (default: the CPU). With ``shard=(rank, world)`` each batch is block
    ``rank`` of ``world`` contiguous blocks of the global batch, and only
    that block is read (``batch_size`` must divide by ``world``).
    """

    def __init__(
        self,
        dataset: ChipDataset,
        batch_size: int = 4,
        shuffle: bool = False,
        drop_last: bool = False,
        prefetch: int = 2,
        rng: T.Optional[np.random.Generator] = None,
        device: T.Union[str, torch.device] = "cpu",
        shard: T.Optional[T.Tuple[int, int]] = None,
    ):
        if shard is not None and batch_size % shard[1]:
            raise ValueError(
                f"batch_size {batch_size} does not split over {shard[1]} "
                "ranks"
            )
        self.dataset = dataset
        self.shard = shard
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = max(1, prefetch)
        self.rng = rng or np.random.default_rng(dataset.random_seed)
        self.device = torch.device(device)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self) -> T.List[np.ndarray]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            order = self.rng.permutation(order)
        batches = [
            order[i : i + self.batch_size]
            for i in range(0, len(order), self.batch_size)
        ]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches = batches[:-1]
        if self.shard is not None:
            rank, world = self.shard
            batches = [
                b[rank * len(b) // world : (rank + 1) * len(b) // world]
                for b in batches
            ]
        return batches

    def skip_epochs(self, epochs: int) -> None:
        """Draw the shuffles of ``epochs`` passes without loading, so that
        a resumed run's next pass has the order an uninterrupted run's
        would."""
        for _ in range(epochs):
            self._batch_indices()

    def _materialize(self, indices: np.ndarray) -> Batch:
        batch = collate([self.dataset[int(i)] for i in indices])
        if self.device.type == "cuda":
            batch = batch.pin_memory().to(self.device)
        return batch

    def __iter__(self) -> T.Iterator[Batch]:
        batches = self._batch_indices()
        if not batches:
            return
        out_queue: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> None:
            while not stop.is_set():
                try:
                    out_queue.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def producer() -> None:
            try:
                for indices in batches:
                    if stop.is_set():
                        return
                    put(self._materialize(indices))
            except Exception as exc:  # handed to the consumer, re-raised there
                put(exc)
            finally:
                put(_DONE)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_queue.get()
                if item is _DONE:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join(timeout=5.0)
