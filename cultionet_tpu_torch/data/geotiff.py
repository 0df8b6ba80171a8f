"""GeoTIFF band reading and raster writing (port of the IO half of
cultionet_tpu/data/geotiff.py).

rasterio when it can be imported, else the pure-Python codec
(``data/tiny_tiff.py``): the choice is about the output format, not the
device. Not ported yet: ``read_time_series`` and ``resample_frame`` (the
CLI's time-series ingestion).
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
