"""Offline chip creation (port of cultionet_tpu/data/create.py): the train
chips of ``create`` and the overlapping window chips of ``create-predict``,
with the scene's window geometry for in-memory predict.

A train chip burns the region's polygons into labels (``label_math.py``,
numpy and scipy), computes the boundary distances and writes one ``.npz``
chip in the JAX package's layout, names and dtypes, so either package's
``ChipDataset`` reads it. Predict windows are written in parallel, by
forked processes or threads, each write verified by a read-back.
"""

import typing as T
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from functools import partial
from pathlib import Path

import numpy as np
import torch

from .batch import Batch
from .label_math import (
    cleanup_edges,
    edge_gradient,
    fillz,
    get_crop_count,
    normalize_boundary_distances,
    polygons_to_array,
)

Shapes = T.Sequence[T.Tuple[T.Any, int]]


def prepare_image_time_series(
    time_series: np.ndarray,
    gain: float = 1e-4,
    offset: float = 0.0,
    fill_zeros: bool = False,
) -> np.ndarray:
    """Gain/offset scaling (for integer records or values above 2), NaN
    masking and, with ``fill_zeros``, the 3 x 3 focal-mean fill of
    zeros over each (H, W) frame; clipped to [0, 1] as float32.

    The train chips fill zeros; the predict path does not, and this is the
    port's default (the JAX function's default is ``fill_zeros=True``).
    """
    x = np.asarray(time_series, dtype="float64")
    apply_gain = np.issubdtype(time_series.dtype, np.integer) or (
        np.nanmax(x) > 2.0 if x.size else False
    )
    if apply_gain:
        x = x * gain + offset
    x = np.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
    if fill_zeros:
        x = np.moveaxis(fillz(np.moveaxis(x, -1, 1)), 1, -1)
    return np.clip(x, 0.0, 1.0).astype("float32")


def is_grid_processed(
    process_path: Path,
    transforms: T.Sequence[str],
    region: str,
    start_date: str,
    end_date: str,
) -> bool:
    """True when every ``data_<region>_<start>_<end>_<transform>.npz`` chip
    exists."""
    return all(
        (
            Path(process_path)
            / f"data_{region}_{start_date}_{end_date}_{aug}.npz"
        ).is_file()
        for aug in transforms
    )


@dataclass
class ReferenceArrays:
    """Label arrays derived from training polygons."""

    labels_array: T.Optional[np.ndarray] = None
    boundary_distance: T.Optional[np.ndarray] = None
    orientation: T.Optional[np.ndarray] = None
    edge_array: T.Optional[np.ndarray] = None

    @classmethod
    def from_polygons(
        cls,
        polygons: Shapes,
        bounds: T.Tuple[float, float, float, float],
        out_shape: T.Tuple[int, int],
        max_crop_class: int,
        edge_class: int,
        cell_res: float,
        keep_crop_classes: bool = False,
        nonag_is_unknown: bool = False,
        geom_type: str = "Polygon",
        all_touched: bool = True,
    ) -> "ReferenceArrays":
        """Burn the polygons (and an instance raster, one id per polygon),
        mark the instance raster's boundaries with ``edge_class``, clean the
        edges up and compute the boundary distances of the crop pixels.
        Crop classes collapse to ``max_crop_class`` unless
        ``keep_crop_classes``; with ``nonag_is_unknown`` the background is
        -1. ``orientation`` is the boundary distance's gradient direction
        (``label_math.normalize_boundary_distances``); no chip holds it."""
        unique_shapes = [
            (poly, idx + 1) for idx, (poly, _) in enumerate(polygons)
        ]
        labels_array_unique = polygons_to_array(
            unique_shapes, bounds, out_shape, all_touched=all_touched
        )

        fill_value, dtype = 0, "uint8"
        if nonag_is_unknown:
            fill_value, dtype = -1, "int16"

        labels_array = polygons_to_array(
            polygons,
            bounds,
            out_shape,
            fill_value=fill_value,
            dtype=dtype,
            all_touched=all_touched,
        )

        # With integer-pixel burn-in the instance raster's morphological
        # gradient is the polygons' boundary.
        edge_array = edge_gradient(labels_array_unique)
        image_grad_count = get_crop_count(edge_array, edge_class)
        edge_array = np.where(image_grad_count > 0, edge_array, 0)

        if not keep_crop_classes:
            labels_array = np.where(
                labels_array > 0, max_crop_class, fill_value
            )

        labels_array = labels_array.astype("int16")
        labels_array[edge_array == 1] = edge_class
        labels_array = cleanup_edges(
            np.where(labels_array == fill_value, 0, labels_array),
            labels_array_unique,
            edge_class,
        )
        labels_array = np.where(labels_array == 0, fill_value, labels_array)

        if labels_array.max() > edge_class:
            raise ValueError(
                f"labels reach {labels_array.max()}, above the edge class "
                f"{edge_class}: raise max_crop_class"
            )

        boundary_distance, orientation = normalize_boundary_distances(
            np.uint8((labels_array > 0) & (labels_array != edge_class)),
            geom_type,
            cell_res,
        )
        return cls(
            labels_array=labels_array,
            boundary_distance=boundary_distance,
            orientation=orientation,
            edge_array=edge_array,
        )


def _host(value, dtype: str) -> torch.Tensor:
    return torch.from_numpy(np.asarray(value, dtype=dtype))


def create_train_batch(
    image_time_series: np.ndarray,  # (T, H, W, C)
    polygons: T.Optional[Shapes],
    bounds: T.Tuple[float, float, float, float],
    cell_res: float,
    region: str,
    process_path: T.Union[str, Path],
    start_date: str = "0",
    end_date: str = "1",
    max_crop_class: int = 1,
    edge_class: T.Optional[int] = None,
    gain: float = 1e-4,
    offset: float = 0.0,
    keep_crop_classes: bool = False,
    nonag_is_unknown: bool = False,
    overwrite: bool = False,
    all_touched: bool = True,
    zero_padding: int = 0,
    grid_size: T.Optional[T.Tuple[int, int]] = None,
    compression: str = "zlib",
) -> T.Optional[Path]:
    """Build one training chip and write it to
    ``process_path/data_<region>_<start>_<end>_none.npz``; returns its
    path, or None when it exists and ``overwrite`` is off.

    ``grid_size`` (rows, cols) refuses a region of another size with
    ``ValueError``; ``zero_padding`` pads H and W with zeros (labels with
    the background) on every side and widens the bounds to match;
    ``all_touched`` also burns each polygon's outline. Without polygons the
    labels are all background and the distances 0.
    """
    process_path = Path(process_path)
    process_path.mkdir(parents=True, exist_ok=True)
    if edge_class is None:
        edge_class = max_crop_class + 1

    if not overwrite and is_grid_processed(
        process_path, ["none"], region, start_date, end_date
    ):
        return None

    x = prepare_image_time_series(
        image_time_series, gain=gain, offset=offset, fill_zeros=True
    )
    _, height, width, _ = x.shape
    if grid_size is not None:
        expected_rows, expected_cols = grid_size
        if (height, width) != (int(expected_rows), int(expected_cols)):
            raise ValueError(
                f"Grid {region} is {height} rows x {width} columns, but "
                f"--grid-size expects {expected_rows} x {expected_cols}"
            )

    fill = -1 if nonag_is_unknown else 0
    if polygons:
        ref = ReferenceArrays.from_polygons(
            polygons=polygons,
            bounds=bounds,
            out_shape=(height, width),
            max_crop_class=max_crop_class,
            edge_class=edge_class,
            cell_res=cell_res,
            keep_crop_classes=keep_crop_classes,
            nonag_is_unknown=nonag_is_unknown,
            all_touched=all_touched,
        )
        labels = ref.labels_array
        bdist = ref.boundary_distance
    else:
        labels = np.full((height, width), fill, dtype="int16")
        bdist = np.zeros((height, width), dtype="float32")

    if zero_padding > 0:
        pad = int(zero_padding)
        x = np.pad(
            x, ((0, 0), (pad, pad), (pad, pad), (0, 0)), mode="constant"
        )
        labels = np.pad(labels, ((pad, pad), (pad, pad)), constant_values=fill)
        bdist = np.pad(bdist, ((pad, pad), (pad, pad)))
        left_pad = pad * cell_res
        bounds = (
            bounds[0] - left_pad,
            bounds[1] - left_pad,
            bounds[2] + left_pad,
            bounds[3] + left_pad,
        )

    left, bottom, right, top = bounds
    train_id = f"data_{region}_{start_date}_{end_date}_none"
    batch = Batch(
        x=_host(x[None], "float32"),
        y=_host(labels[None], "int32"),
        bdist=_host(bdist[None], "float32"),
        left=_host([left], "float32"),
        bottom=_host([bottom], "float32"),
        right=_host([right], "float32"),
        top=_host([top], "float32"),
        batch_id=(f"{train_id}.npz",),
    )
    out_path = process_path / f"{train_id}.npz"
    batch.to_file(out_path, compression=compression)
    return out_path


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

        batch = Batch(
            x=_host(x_window[None], "float32"),
            window_row_off=_host([row_off], "int32"),
            window_col_off=_host([col_off], "int32"),
            window_height=_host([window_height], "int32"),
            window_width=_host([window_width], "int32"),
            window_pad_bottom=_host([max(pad_bottom, 0)], "int32"),
            window_pad_right=_host([max(pad_right, 0)], "int32"),
            left=_host([left], "float32"),
            bottom=_host([bottom], "float32"),
            right=_host([right], "float32"),
            top=_host([top], "float32"),
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
