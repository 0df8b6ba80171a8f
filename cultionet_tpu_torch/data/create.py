"""Scene windowing for in-memory predict (port-owned copies of
cultionet_tpu/data/create.py::iter_window_jobs, _slice_window and the
``fill_zeros=False`` path of prepare_image_time_series)."""

import typing as T

import numpy as np


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
