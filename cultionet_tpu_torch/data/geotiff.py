"""GeoTIFF time-series reading and raster writing (port of
cultionet_tpu/data/geotiff.py).

rasterio when it can be imported, else the pure-Python codec
(``data/tiny_tiff.py``): the choice is about the file format, not the
device. ``read_time_series`` stacks ``<region>/<variable>/<date>.tif`` into
the (T, H, W, C) cube the command line's ``create`` and ``create-predict``
read when a region has no ``scene.npz``.
"""

import typing as T
from pathlib import Path

import numpy as np


def _rasterio():
    try:
        import rasterio

        return rasterio
    except ImportError:
        return None


def has_rasterio() -> bool:
    return _rasterio() is not None


def read_tiff_band(
    path: T.Union[str, Path],
) -> T.Tuple[
    np.ndarray,
    T.Optional[T.Tuple[float, float, float, float]],
    T.Optional[float],
    T.Optional[str],
]:
    """The first band, the bounds (left, bottom, right, top), the cell
    size and the CRS string of a TIFF."""
    rio = _rasterio()
    if rio is not None:
        with rio.open(path) as src:
            return (
                src.read(1),
                tuple(src.bounds),
                abs(src.transform.a),
                str(src.crs) if src.crs else None,
            )
    from .tiny_tiff import read_tiff

    return read_tiff(path)


def resample_frame(
    frame: np.ndarray,
    out_shape: T.Tuple[int, int],
    method: str = "nearest",
) -> np.ndarray:
    """Resample one (H, W) frame onto a target grid over the same bounds:
    nearest or bilinear on pixel centers, in numpy."""
    in_h, in_w = frame.shape
    out_h, out_w = out_shape
    if (in_h, in_w) == (out_h, out_w):
        return frame
    # Map output pixel centers to input fractional pixel coordinates.
    rows = (np.arange(out_h) + 0.5) * (in_h / out_h) - 0.5
    cols = (np.arange(out_w) + 0.5) * (in_w / out_w) - 0.5
    if method == "nearest":
        ri = np.clip(np.round(rows).astype(np.int64), 0, in_h - 1)
        ci = np.clip(np.round(cols).astype(np.int64), 0, in_w - 1)
        return frame[np.ix_(ri, ci)]
    if method != "bilinear":
        raise ValueError(
            f"resampling must be 'nearest' or 'bilinear', got {method!r}"
        )
    r0 = np.clip(np.floor(rows).astype(np.int64), 0, in_h - 1)
    r1 = np.clip(r0 + 1, 0, in_h - 1)
    c0 = np.clip(np.floor(cols).astype(np.int64), 0, in_w - 1)
    c1 = np.clip(c0 + 1, 0, in_w - 1)
    wr = np.clip(rows - r0, 0.0, 1.0)[:, None]
    wc = np.clip(cols - c0, 0.0, 1.0)[None, :]
    f = frame.astype(np.float64)
    top = f[np.ix_(r0, c0)] * (1 - wc) + f[np.ix_(r0, c1)] * wc
    bot = f[np.ix_(r1, c0)] * (1 - wc) + f[np.ix_(r1, c1)] * wc
    out = top * (1 - wr) + bot * wr
    if np.issubdtype(frame.dtype, np.integer):
        out = np.round(out)
    return out.astype(frame.dtype)


def read_time_series(
    region_path: T.Union[str, Path],
    end_year: T.Optional[int] = None,
    start_mmdd: T.Optional[str] = None,
    end_mmdd: T.Optional[str] = None,
    num_months: T.Optional[int] = None,
    ref_res: T.Optional[float] = None,
    resampling: str = "nearest",
    date_format: T.Optional[str] = None,
    var_dirs: T.Optional[T.Sequence[T.Union[str, Path]]] = None,
    skip_index: int = 0,
) -> T.Tuple[
    np.ndarray,
    T.Tuple[float, float, float, float],
    float,
    T.Optional[str],
]:
    """Read ``<region>/<variable>/*.tif`` into (T, H, W, C) + bounds +
    res + CRS string.

    Variables are sorted directories (one per band or vegetation index),
    or ``var_dirs``; dates are sorted file stems. With a seasonal window
    (``end_year``, ``start_mmdd``, ``end_mmdd``) the files come from
    ``utils/model_preprocessing.py::get_time_series_list``; ``skip_index``
    keeps every skip_index-th file.

    ``ref_res`` resamples every band onto that resolution (``resampling``:
    nearest or bilinear), so mixed-resolution sources (10 m and 20 m
    Sentinel-2 bands, say) stack into one cube; without it a band whose
    grid differs from the first band's is resampled onto the first's.
    """
    region_path = Path(region_path)

    if var_dirs is not None:
        var_dirs = [Path(p) for p in var_dirs]
        missing = [str(p) for p in var_dirs if not p.is_dir()]
        if missing:
            raise FileNotFoundError(
                f"feature_pattern dirs not found: {missing}"
            )
    else:
        var_dirs = sorted(p for p in region_path.iterdir() if p.is_dir())
    if not var_dirs:
        raise FileNotFoundError(f"No variable directories in {region_path}")

    def list_files(var_dir: Path) -> T.List[Path]:
        if end_year is not None and start_mmdd and end_mmdd:
            from ..utils.model_preprocessing import get_time_series_list

            kwargs = dict(
                end_year=end_year,
                start_mmdd=start_mmdd,
                end_mmdd=end_mmdd,
                num_months=num_months,
            )
            if date_format is not None:
                kwargs["date_format"] = date_format
            files = get_time_series_list(var_dir, **kwargs)
        else:
            files = sorted(var_dir.glob("*.tif"))
        if skip_index and skip_index > 0:
            files = files[::skip_index]
        return files

    bands = []
    bounds = None
    cell_res = None
    crs = None
    out_shape = None
    for var_dir in var_dirs:
        files = list_files(var_dir)
        if not files:
            raise FileNotFoundError(f"No .tif files in {var_dir}")
        frames = []
        for tif in files:
            frame, fb, fres, fcrs = read_tiff_band(tif)
            if bounds is None and fb is not None:
                bounds, cell_res, crs = fb, fres, fcrs
                if ref_res is not None:
                    left, bottom, right, top = bounds
                    out_shape = (
                        int(round((top - bottom) / ref_res)),
                        int(round((right - left) / ref_res)),
                    )
                    cell_res = float(ref_res)
            if out_shape is not None:
                frame = resample_frame(frame, out_shape, method=resampling)
            elif bands and frame.shape != bands[0].shape[1:]:
                # Mixed resolutions without ref_res: resample onto the
                # first band's grid so the cube stacks.
                frame = resample_frame(
                    frame, bands[0].shape[1:], method=resampling
                )
            frames.append(frame)
        bands.append(np.stack(frames))  # (T, H, W)

    x = np.stack(bands, axis=-1)  # (T, H, W, C)
    if bounds is None:
        bounds = (0.0, 0.0, float(x.shape[2]), float(x.shape[1]))
        cell_res = 1.0
    return x, bounds, cell_res, crs


def write_geotiff(
    path: T.Union[str, Path],
    raster: np.ndarray,  # (bands, H, W)
    bounds: T.Optional[T.Tuple[float, float, float, float]] = None,
    crs: T.Optional[str] = None,
    dtype: str = "uint16",
    compress: str = "lzw",
    profile: T.Optional[dict] = None,
) -> Path:
    """Write a multi-band GeoTIFF, georeferenced when ``bounds`` is given.

    With rasterio: an LZW-compressed GTiff whose profile ``profile``
    updates last. Without: the codec's uncompressed, pixel-interleaved
    TIFF (``profile`` does not apply).
    """
    path = Path(path)
    rio = _rasterio()
    if rio is None:
        from .tiny_tiff import write_tiff

        return write_tiff(path, raster.astype(dtype), bounds=bounds, crs=crs)

    from rasterio.transform import from_bounds

    count, height, width = raster.shape
    options = dict(
        driver="GTiff",
        height=height,
        width=width,
        count=count,
        dtype=dtype,
        compress=compress,
    )
    if bounds is not None:
        options["transform"] = from_bounds(*bounds, width=width, height=height)
    if crs is not None:
        options["crs"] = rio.crs.CRS.from_string(str(crs))
    options.update(profile or {})
    with rio.open(path, "w", **options) as dst:
        dst.write(raster.astype(dtype))
    return path
