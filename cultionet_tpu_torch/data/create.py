"""Predict windows: the scene's window geometry for in-memory predict, and
the window chips of ``create-predict`` (port-owned copies of
cultionet_tpu/data/create.py::iter_window_jobs, _slice_window,
BatchStore, create_predict_dataset and the ``fill_zeros=False`` path of
prepare_image_time_series).

Not ported yet: the train chips (``create_train_batch``, with
``label_math.py`` and ``vector.py``).
"""

import typing as T
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path

import numpy as np
import torch

from .batch import Batch


def prepare_image_time_series(
    time_series: np.ndarray,
    gain: float = 1e-4,
    offset: float = 0.0,
) -> np.ndarray:
    """Gain/offset scaling and NaN masking, clipped to [0, 1] (no focal-mean
    zero fill: the predict path does not use it)."""
    x = np.asarray(time_series, dtype="float64")
    apply_gain = np.issubdtype(time_series.dtype, np.integer) or (
        np.nanmax(x) > 2.0 if x.size else False
    )
    if apply_gain:
        x = x * gain + offset
    x = np.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
    return np.clip(x, 0.0, 1.0).astype("float32")


def iter_window_jobs(
    height: int, width: int, window_size: int, padding: int
) -> T.Iterator[dict]:
    """Window index geometry for one scene: interior offsets plus the
    padded read slice and the top/left zero-pad a window near the scene
    edge needs."""
    for row_off in range(0, height, window_size):
        for col_off in range(0, width, window_size):
            window_height = min(window_size, height - row_off)
            window_width = min(window_size, width - col_off)
            read_r0 = max(0, row_off - padding)
            read_c0 = max(0, col_off - padding)
            read_r1 = min(height, row_off + window_height + padding)
            read_c1 = min(width, col_off + window_width + padding)
            yield dict(
                row_off=row_off,
                col_off=col_off,
                window_height=window_height,
                window_width=window_width,
                read=(read_r0, read_r1, read_c0, read_c1),
                pad_top=padding - (row_off - read_r0),
                pad_left=padding - (col_off - read_c0),
            )


def _slice_window(x: np.ndarray, job: dict) -> np.ndarray:
    read_r0, read_r1, read_c0, read_c1 = job["read"]
    window = x[:, read_r0:read_r1, read_c0:read_c1]
    if job["pad_top"] > 0 or job["pad_left"] > 0:
        window = np.pad(
            window,
            ((0, 0), (job["pad_top"], 0), (job["pad_left"], 0), (0, 0)),
            mode="constant",
        )
    return window


# What np.load raises on a chip whose write did not complete.
_CORRUPT_CHIP = (OSError, ValueError, EOFError, zipfile.BadZipFile, zlib.error)


class BatchStore:
    """Write overlapping windows as uniform-size chips with their offsets
    stamped: edge windows are zero-padded to window_size + 2*padding, the
    window geometry and the scene bounds ride in the Batch, and every
    write is verified by a read-back, with retries."""

    def __init__(
        self,
        write_path: T.Union[str, Path],
        window_size: int,
        padding: int,
        region: str,
        start_date: str,
        end_date: str,
        bounds: T.Tuple[float, float, float, float] = (0.0, 0.0, 1.0, 1.0),
        retries: int = 5,
        compression: str = "zlib",
    ):
        self.write_path = Path(write_path)
        self.write_path.mkdir(parents=True, exist_ok=True)
        self.window_size = window_size
        self.padding = padding
        self.region = region
        self.start_date = start_date
        self.end_date = end_date
        self.bounds = bounds
        self.retries = retries
        self.compression = compression

    def write_window(
        self,
        x_window: np.ndarray,  # (T, Hw, Ww, C), may be smaller at edges
        row_off: int,
        col_off: int,
        window_height: int,
        window_width: int,
    ) -> Path:
        image_size = self.window_size + self.padding * 2
        pad_bottom = image_size - x_window.shape[1]
        pad_right = image_size - x_window.shape[2]
        if pad_bottom > 0 or pad_right > 0:
            x_window = np.pad(
                x_window,
                ((0, 0), (0, pad_bottom), (0, pad_right), (0, 0)),
                mode="constant",
            )
        if x_window.shape[1:3] != (image_size, image_size):
            raise ValueError(
                f"window {x_window.shape[1:3]} larger than {image_size}"
            )

        batch_id = (
            f"data_{self.region}_{self.start_date}_{self.end_date}_"
            f"{row_off}_{col_off}"
        )
        left, bottom, right, top = self.bounds

        def one(value, dtype: str) -> torch.Tensor:
            return torch.from_numpy(np.asarray([value], dtype=dtype))

        batch = Batch(
            x=torch.from_numpy(np.asarray(x_window[None], dtype="float32")),
            window_row_off=one(row_off, "int32"),
            window_col_off=one(col_off, "int32"),
            window_height=one(window_height, "int32"),
            window_width=one(window_width, "int32"),
            window_pad_bottom=one(max(pad_bottom, 0), "int32"),
            window_pad_right=one(max(pad_right, 0), "int32"),
            left=one(left, "float32"),
            bottom=one(bottom, "float32"),
            right=one(right, "float32"),
            top=one(top, "float32"),
            batch_id=(f"{batch_id}.npz",),
        )
        out_path = self.write_path / f"{batch_id}.npz"

        last_error: T.Optional[Exception] = None
        for _ in range(self.retries):
            batch.to_file(out_path, compression=self.compression)
            try:
                Batch.from_file(out_path)
                return out_path
            except _CORRUPT_CHIP as exc:
                last_error = exc
        raise IOError(f"Failed to verify window write {out_path}: {last_error}")


def _fork_available() -> bool:
    import multiprocessing

    return "fork" in multiprocessing.get_all_start_methods()


def _write_job(x: np.ndarray, store: BatchStore, job: dict) -> Path:
    return store.write_window(
        x_window=_slice_window(x, job),
        row_off=job["row_off"],
        col_off=job["col_off"],
        window_height=job["window_height"],
        window_width=job["window_width"],
    )


# The prepared scene and the store reach the process pool's workers by
# fork (copy on write), not by pickling pixels per job.
_WORKER_CTX: T.Optional[T.Tuple[np.ndarray, BatchStore]] = None


def _window_worker(job: dict) -> Path:
    return _write_job(*_WORKER_CTX, job)


def create_predict_dataset(
    image_time_series: np.ndarray,  # (T, H, W, C)
    region: str,
    process_path: T.Union[str, Path],
    start_date: str = "0",
    end_date: str = "1",
    window_size: int = 100,
    padding: int = 20,
    gain: float = 1e-4,
    offset: float = 0.0,
    bounds: T.Tuple[float, float, float, float] = (0.0, 0.0, 1.0, 1.0),
    num_workers: int = 4,
    use_processes: T.Union[bool, str] = "auto",
    compression: str = "zlib",
) -> T.List[Path]:
    """Split a scene into overlapping uniform windows and write one chip
    per window, in parallel; returns the chips' paths in window order.

    ``use_processes``: True forces a process pool, False a thread pool;
    "auto" picks processes where fork is available and num_workers > 1
    (the npz compression is Python under the interpreter lock, so threads
    do not scale it). The forked workers only slice numpy arrays and write
    files: they touch no CUDA state and no torch thread pool.
    """
    x = prepare_image_time_series(image_time_series, gain=gain, offset=offset)
    _, height, width, _ = x.shape
    store = BatchStore(
        write_path=process_path,
        window_size=window_size,
        padding=padding,
        region=region,
        start_date=start_date,
        end_date=end_date,
        bounds=bounds,
        compression=compression,
    )
    jobs = list(iter_window_jobs(height, width, window_size, padding))
    num_workers = max(1, num_workers)
    if use_processes == "auto":
        use_processes = num_workers > 1 and _fork_available()

    if num_workers == 1:
        return [_write_job(x, store, job) for job in jobs]
    if use_processes:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        global _WORKER_CTX
        _WORKER_CTX = (x, store)
        try:
            ctx = multiprocessing.get_context("fork")
            with ProcessPoolExecutor(
                max_workers=num_workers, mp_context=ctx
            ) as pool:
                return list(pool.map(_window_worker, jobs, chunksize=4))
        finally:
            _WORKER_CTX = None
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        return list(pool.map(partial(_write_job, x, store), jobs))
