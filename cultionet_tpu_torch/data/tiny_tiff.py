"""Minimal pure-Python (Geo)TIFF codec, no GDAL or rasterio (port-owned
copy of cultionet_tpu/data/tiny_tiff.py).

It covers the subset the package writes and reads:

- write: single- or multi-band (chunky interleaved), single-strip,
  uncompressed, little-endian
- read: stripped or tiled layouts; uncompressed, LZW (with the horizontal
  predictor), Deflate/zlib and PackBits compression, enough for
  GDAL-produced GeoTIFFs
- uint8/uint16/int16/int32/uint32/float32/float64 sample formats
- GeoTIFF georeferencing: the ModelPixelScale and ModelTiepoint tags and
  the GeoKeyDirectory's ProjectedCSType/GeographicType EPSG code

``data/geotiff.py`` uses rasterio when it can be imported and this codec
otherwise.
"""

import struct
import typing as T
from pathlib import Path

import numpy as np

# TIFF tag ids
_IMAGE_WIDTH = 256
_IMAGE_LENGTH = 257
_BITS_PER_SAMPLE = 258
_COMPRESSION = 259
_PHOTOMETRIC = 262
_STRIP_OFFSETS = 273
_SAMPLES_PER_PIXEL = 277
_ROWS_PER_STRIP = 278
_STRIP_BYTE_COUNTS = 279
_PLANAR_CONFIG = 284
_PREDICTOR = 317
_TILE_WIDTH = 322
_TILE_LENGTH = 323
_TILE_OFFSETS = 324
_TILE_BYTE_COUNTS = 325
_SAMPLE_FORMAT = 339
_MODEL_PIXEL_SCALE = 33550
_MODEL_TIEPOINT = 33922
_GEO_KEY_DIRECTORY = 34735

# TIFF field types
_T_SHORT = 3
_T_LONG = 4
_T_DOUBLE = 12

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
               10: 8, 11: 4, 12: 8}
_TYPE_FMT = {3: "H", 4: "I", 12: "d", 1: "B", 2: "c", 6: "b", 8: "h",
             9: "i", 11: "f"}

# (sample_format, bits) -> numpy dtype
_DTYPES = {
    (1, 8): np.uint8,
    (1, 16): np.uint16,
    (1, 32): np.uint32,
    (2, 16): np.int16,
    (2, 32): np.int32,
    (3, 32): np.float32,
    (3, 64): np.float64,
}
_REV_DTYPES = {np.dtype(v): k for k, v in _DTYPES.items()}

# GeoKey ids
_GK_MODEL_TYPE = 1024
_GK_RASTER_TYPE = 1025
_GK_GEOGRAPHIC_TYPE = 2048
_GK_PROJECTED_CS_TYPE = 3072


def write_tiff(
    path: T.Union[str, Path],
    array: np.ndarray,  # (H, W) or (bands, H, W)
    bounds: T.Optional[T.Tuple[float, float, float, float]] = None,
    crs: T.Optional[str] = None,
) -> Path:
    """Write a georeferenced baseline TIFF (multi-band = chunky interleave).

    ``bounds`` = (left, bottom, right, top); ``crs`` like "EPSG:32633".
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    array = np.ascontiguousarray(array)
    if array.ndim == 2:
        array = array[None]
    if array.ndim != 3:
        raise ValueError(f"Expected (H, W) or (bands, H, W), got {array.shape}")
    spp, h, w = array.shape
    dt = np.dtype(array.dtype).newbyteorder("<")
    if np.dtype(array.dtype) not in _REV_DTYPES:
        raise ValueError(f"Unsupported dtype {array.dtype}")
    sample_format, bits = _REV_DTYPES[np.dtype(array.dtype)]
    # chunky (pixel-interleaved) layout: (H, W, spp)
    data = np.ascontiguousarray(
        np.moveaxis(array, 0, -1).astype(dt)
    ).tobytes()

    entries: T.List[T.Tuple[int, int, int, T.Union[int, bytes]]] = []

    def entry(tag, ftype, values):
        if not isinstance(values, (list, tuple)):
            values = [values]
        count = len(values)
        fmt = "<" + _TYPE_FMT[ftype] * count
        packed = struct.pack(fmt, *values)
        entries.append((tag, ftype, count, packed))

    entry(_IMAGE_WIDTH, _T_LONG, w)
    entry(_IMAGE_LENGTH, _T_LONG, h)
    entry(_BITS_PER_SAMPLE, _T_SHORT, [bits] * spp)
    entry(_COMPRESSION, _T_SHORT, 1)
    entry(_PHOTOMETRIC, _T_SHORT, 1)
    entry(_STRIP_OFFSETS, _T_LONG, 0)  # patched below
    entry(_SAMPLES_PER_PIXEL, _T_SHORT, spp)
    entry(_ROWS_PER_STRIP, _T_LONG, h)
    entry(_STRIP_BYTE_COUNTS, _T_LONG, len(data))
    entry(_PLANAR_CONFIG, _T_SHORT, 1)
    entry(_SAMPLE_FORMAT, _T_SHORT, [sample_format] * spp)

    if bounds is not None:
        left, bottom, right, top = bounds
        sx = (right - left) / w
        sy = (top - bottom) / h
        entry(_MODEL_PIXEL_SCALE, _T_DOUBLE, [sx, sy, 0.0])
        entry(_MODEL_TIEPOINT, _T_DOUBLE, [0.0, 0.0, 0.0, left, top, 0.0])
    if crs is not None:
        code = int(str(crs).upper().replace("EPSG:", ""))
        geographic = 4000 <= code < 5000
        keys = [
            (_GK_MODEL_TYPE, 0, 1, 2 if geographic else 1),
            (_GK_RASTER_TYPE, 0, 1, 1),
            (
                _GK_GEOGRAPHIC_TYPE if geographic else _GK_PROJECTED_CS_TYPE,
                0,
                1,
                code,
            ),
        ]
        flat = [1, 1, 0, len(keys)]
        for k in keys:
            flat.extend(k)
        entry(_GEO_KEY_DIRECTORY, _T_SHORT, flat)

    entries.sort(key=lambda e: e[0])

    # Layout: header (8) | IFD | out-of-line values | strip data
    ifd_offset = 8
    ifd_size = 2 + len(entries) * 12 + 4
    extra_offset = ifd_offset + ifd_size
    extra = b""
    packed_entries = []
    for tag, ftype, count, payload in entries:
        size = _TYPE_SIZES[ftype] * count
        if size <= 4:
            value_field = payload + b"\x00" * (4 - size)
        else:
            value_field = struct.pack("<I", extra_offset + len(extra))
            extra += payload
        packed_entries.append((tag, ftype, count, value_field))

    data_offset = extra_offset + len(extra)
    # Patch StripOffsets (its 4-byte inline value)
    packed_entries = [
        (
            tag,
            ftype,
            count,
            struct.pack("<I", data_offset)
            if tag == _STRIP_OFFSETS
            else value,
        )
        for tag, ftype, count, value in packed_entries
    ]

    with open(path, "wb") as fh:
        fh.write(b"II*\x00")
        fh.write(struct.pack("<I", ifd_offset))
        fh.write(struct.pack("<H", len(packed_entries)))
        for tag, ftype, count, value in packed_entries:
            fh.write(struct.pack("<HHI", tag, ftype, count))
            fh.write(value)
        fh.write(struct.pack("<I", 0))  # no next IFD
        fh.write(extra)
        fh.write(data)
    return path


def _lzw_decode(data: bytes) -> bytes:
    """TIFF-variant LZW (MSB-first codes, early width change)."""
    out = bytearray()
    table: T.List[bytes] = []
    width = 9
    prev: T.Optional[bytes] = None
    bitbuf = 0
    nbits = 0
    pos = 0
    n = len(data)

    def reset_table():
        t = [bytes([i]) for i in range(256)]
        t.append(b"")  # 256 = Clear
        t.append(b"")  # 257 = EOI
        return t

    table = reset_table()
    while True:
        while nbits < width:
            if pos >= n:
                return bytes(out)
            bitbuf = (bitbuf << 8) | data[pos]
            pos += 1
            nbits += 8
        code = (bitbuf >> (nbits - width)) & ((1 << width) - 1)
        nbits -= width
        if code == 256:
            table = reset_table()
            width = 9
            prev = None
            continue
        if code == 257:
            return bytes(out)
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        else:
            entry = prev + prev[:1]
            table.append(entry)
        out += entry
        prev = entry
        # TIFF early change: bump width when the NEXT code would not fit.
        if len(table) >= (1 << width) - 1 and width < 12:
            width += 1
    return bytes(out)


def _packbits_decode(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        hdr = data[i]
        i += 1
        if hdr < 128:
            out += data[i : i + hdr + 1]
            i += hdr + 1
        elif hdr > 128:
            out += data[i : i + 1] * (257 - hdr)
            i += 1
    return bytes(out)


def _decompress(data: bytes, compression: int) -> bytes:
    if compression == 1:
        return data
    if compression == 5:
        return _lzw_decode(data)
    if compression in (8, 32946):  # Deflate / legacy zlib
        import zlib

        return zlib.decompress(data)
    if compression == 32773:
        return _packbits_decode(data)
    raise ValueError(f"Unsupported TIFF compression {compression}")


def _undo_predictor(rows: np.ndarray, predictor: int) -> np.ndarray:
    """Horizontal differencing (predictor=2) on (rows, width, spp):
    cumulative sum along the width axis, per sample component."""
    if predictor == 2:
        return np.cumsum(
            rows.astype(np.int64), axis=1, dtype=np.int64
        ).astype(rows.dtype)
    return rows


def read_tiff(
    path: T.Union[str, Path],
) -> T.Tuple[
    np.ndarray,
    T.Optional[T.Tuple[float, float, float, float]],
    T.Optional[float],
    T.Optional[str],
]:
    """Read a single-band baseline TIFF -> (array, bounds, cell_res, crs)."""
    blob = Path(path).read_bytes()
    if blob[:2] == b"II":
        bo = "<"
    elif blob[:2] == b"MM":
        bo = ">"
    else:
        raise ValueError(f"Not a TIFF: {path}")
    magic, ifd_offset = struct.unpack(bo + "HI", blob[2:8])
    if magic != 42:
        raise ValueError(f"Not a classic TIFF: {path}")

    (num_entries,) = struct.unpack(
        bo + "H", blob[ifd_offset : ifd_offset + 2]
    )
    tags: T.Dict[int, T.List] = {}
    for i in range(num_entries):
        off = ifd_offset + 2 + i * 12
        tag, ftype, count = struct.unpack(bo + "HHI", blob[off : off + 8])
        if ftype not in _TYPE_FMT:
            continue
        size = _TYPE_SIZES[ftype] * count
        if size <= 4:
            payload = blob[off + 8 : off + 8 + size]
        else:
            (value_offset,) = struct.unpack(
                bo + "I", blob[off + 8 : off + 12]
            )
            payload = blob[value_offset : value_offset + size]
        values = list(
            struct.unpack(bo + _TYPE_FMT[ftype] * count, payload)
        )
        tags[tag] = values

    w = int(tags[_IMAGE_WIDTH][0])
    h = int(tags[_IMAGE_LENGTH][0])
    bits = int(tags.get(_BITS_PER_SAMPLE, [8])[0])
    compression = int(tags.get(_COMPRESSION, [1])[0])
    spp = int(tags.get(_SAMPLES_PER_PIXEL, [1])[0])
    planar = int(tags.get(_PLANAR_CONFIG, [1])[0])
    if spp > 1 and planar != 1:
        raise ValueError("Only chunky (interleaved) multi-band supported")
    sample_format = int(tags.get(_SAMPLE_FORMAT, [1])[0])
    dtype = _DTYPES.get((sample_format, bits))
    if dtype is None:
        raise ValueError(f"Unsupported sample format {sample_format}/{bits}")
    predictor = int(tags.get(_PREDICTOR, [1])[0])
    dt = np.dtype(dtype).newbyteorder(bo)

    if _TILE_OFFSETS in tags:
        # Tiled layout (GDAL default for many products): tiles run across
        # then down; edge tiles are padded to (tile_len, tile_w).
        tw = int(tags[_TILE_WIDTH][0])
        tl = int(tags[_TILE_LENGTH][0])
        across = -(-w // tw)
        down = -(-h // tl)
        grid = np.zeros((down * tl, across * tw, spp), dtype=dtype)
        for ti, (o, c) in enumerate(
            zip(tags[_TILE_OFFSETS], tags[_TILE_BYTE_COUNTS])
        ):
            raw = _decompress(blob[int(o) : int(o) + int(c)], compression)
            tile = np.frombuffer(raw, dtype=dt, count=tl * tw * spp)
            tile = tile.reshape(tl, tw, spp)
            tile = _undo_predictor(tile, predictor)
            r0 = (ti // across) * tl
            c0 = (ti % across) * tw
            grid[r0 : r0 + tl, c0 : c0 + tw] = tile
        pixels = grid[:h, :w]
    else:
        rows_per_strip = int(tags.get(_ROWS_PER_STRIP, [h])[0])
        offsets = tags[_STRIP_OFFSETS]
        counts = tags[_STRIP_BYTE_COUNTS]
        rows_out = []
        row = 0
        for o, c in zip(offsets, counts):
            nrows = min(rows_per_strip, h - row)
            raw = _decompress(blob[int(o) : int(o) + int(c)], compression)
            strip = np.frombuffer(raw, dtype=dt, count=nrows * w * spp)
            strip = strip.reshape(nrows, w, spp)
            rows_out.append(_undo_predictor(strip, predictor))
            row += nrows
        pixels = np.concatenate(rows_out, axis=0)

    if spp > 1:
        array = np.moveaxis(pixels, -1, 0).astype(dtype)  # -> (bands, H, W)
    else:
        array = pixels[..., 0].astype(dtype)

    bounds = None
    cell_res = None
    if _MODEL_PIXEL_SCALE in tags and _MODEL_TIEPOINT in tags:
        sx, sy = tags[_MODEL_PIXEL_SCALE][:2]
        tp = tags[_MODEL_TIEPOINT]
        # tiepoint: raster (i, j, k) -> model (x, y, z); standard top-left
        left = tp[3] - tp[0] * sx
        top = tp[4] + tp[1] * sy
        bounds = (left, top - h * sy, left + w * sx, top)
        cell_res = float(sx)

    crs = None
    if _GEO_KEY_DIRECTORY in tags:
        keys = tags[_GEO_KEY_DIRECTORY]
        num_keys = int(keys[3])
        for i in range(num_keys):
            kid, _, cnt, val = keys[4 + 4 * i : 8 + 4 * i]
            if kid in (_GK_PROJECTED_CS_TYPE, _GK_GEOGRAPHIC_TYPE) and (
                cnt == 1
            ):
                crs = f"EPSG:{int(val)}"
    return array, bounds, cell_res, crs
