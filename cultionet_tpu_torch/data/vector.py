"""Training polygons without GDAL or geopandas (port-owned copy of
cultionet_tpu/data/vector.py).

GeoJSON is parsed directly, GeoPackages through the standard library's
``sqlite3`` and a WKB parser, and "clipping" a shared polygon layer to a
region is a bounding-box filter: the burn-in (``data/label_math.py``)
rasterizes against the region grid, so a polygon partly outside the grid
contributes only its in-grid pixels.
"""

import json
import sqlite3
import struct
import typing as T
from pathlib import Path

import numpy as np

Ring = np.ndarray  # (N, 2) exterior-ring coordinates
Shapes = T.List[T.Tuple[Ring, int]]

_CLASS_KEYS = ("class", "crop_class", "class_value", "value", "DN", "id")
_CLASS_KEYS_LOWER = tuple(k.lower() for k in _CLASS_KEYS)


def _feature_class(
    properties: T.Optional[dict], class_column: T.Optional[str] = None
) -> int:
    if properties:
        keys = [class_column] if class_column else _CLASS_KEYS
        for key in keys:
            if key in properties and properties[key] is not None:
                try:
                    return int(properties[key])
                except (TypeError, ValueError):
                    continue
    return 1


def _rings_from_geometry(geometry: dict) -> T.List[Ring]:
    """Exterior rings of Polygon / MultiPolygon geometries (holes are not
    represented by the reference's label math either — rasterized labels
    use filled exteriors, data/utils.py:272)."""
    gtype = geometry.get("type")
    coords = geometry.get("coordinates")
    if gtype == "Polygon":
        return [np.asarray(coords[0], dtype="float64")]
    if gtype == "MultiPolygon":
        return [np.asarray(poly[0], dtype="float64") for poly in coords]
    if gtype == "GeometryCollection":
        rings: T.List[Ring] = []
        for geom in geometry.get("geometries", []):
            rings.extend(_rings_from_geometry(geom))
        return rings
    return []


def parse_geojson(
    source: T.Union[str, Path, dict],
    class_column: T.Optional[str] = None,
) -> Shapes:
    """(ring, class_value) pairs from a GeoJSON FeatureCollection /
    Feature / bare geometry. ``class_column`` pins the class attribute
    (reference --crop-column); default auto-detects common names."""
    if isinstance(source, (str, Path)):
        source = json.loads(Path(source).read_text())

    gtype = source.get("type")
    if gtype == "FeatureCollection":
        shapes: Shapes = []
        for feature in source.get("features", []):
            value = _feature_class(feature.get("properties"), class_column)
            for ring in _rings_from_geometry(feature.get("geometry") or {}):
                shapes.append((ring, value))
        return shapes
    if gtype == "Feature":
        value = _feature_class(source.get("properties"), class_column)
        return [
            (ring, value)
            for ring in _rings_from_geometry(source.get("geometry") or {})
        ]
    return [(ring, 1) for ring in _rings_from_geometry(source)]


def filter_by_bounds(
    shapes: Shapes, bounds: T.Tuple[float, float, float, float]
) -> Shapes:
    """Keep shapes whose bbox intersects (left, bottom, right, top) — the
    per-grid polygon clip (reference gpd.clip, scripts/cultionet.py:266)."""
    left, bottom, right, top = bounds
    kept: Shapes = []
    for ring, value in shapes:
        xs, ys = ring[:, 0], ring[:, 1]
        if (
            xs.min() <= right
            and xs.max() >= left
            and ys.min() <= top
            and ys.max() >= bottom
        ):
            kept.append((ring, value))
    return kept


def apply_replace_dict(
    shapes: T.Optional[Shapes], replace_dict: T.Optional[T.Dict[int, int]]
) -> T.Optional[Shapes]:
    """Recode polygon class values (reference ``--replace-dict`` /
    create.py:575-577, e.g. {61: 0, 141: 1} to collapse CDL codes)."""
    if shapes is None or not replace_dict:
        return shapes
    return [
        (ring, int(replace_dict.get(int(cls), int(cls))))
        for ring, cls in shapes
    ]


def read_region_polygons(
    region_path: T.Union[str, Path],
    bounds: T.Optional[T.Tuple[float, float, float, float]] = None,
    project_path: T.Optional[T.Union[str, Path]] = None,
    class_column: T.Optional[str] = None,
    replace_dict: T.Optional[T.Dict[int, int]] = None,
) -> T.Optional[Shapes]:
    """Polygons for one region, first match wins:

    1. ``<region>/polygons.json`` — [[ring, class], ...] pairs (native)
    2. ``<region>/polygons.geojson`` — GeoJSON FeatureCollection
    3. ``<region>/polygons.gpkg`` — GeoPackage feature table
    4. ``<project>/user_train/<region>_poly_*.gpkg`` — the REFERENCE's
       training-vector layout (scripts config user_train files)
    5. ``<project>/polygons.geojson`` — project-wide GeoJSON, bbox-clipped
       to the region bounds (the reference's per-grid clip of the shared
       training-polygon layer)

    ``class_column`` selects the vector attribute carrying the crop class
    (reference ``--crop-column``, default auto-detected); ``replace_dict``
    recodes class values after reading.
    """

    def done(shapes):
        return apply_replace_dict(shapes, replace_dict)

    region_path = Path(region_path)
    native = region_path / "polygons.json"
    if native.is_file():
        raw = json.loads(native.read_text())
        return done(
            [
                (np.asarray(ring, dtype="float64"), int(value))
                for ring, value in raw
            ]
        )
    regional = region_path / "polygons.geojson"
    if regional.is_file():
        return done(parse_geojson(regional, class_column=class_column))
    regional_gpkg = region_path / "polygons.gpkg"
    if regional_gpkg.is_file():
        return done(read_gpkg(regional_gpkg, class_column=class_column))
    if project_path is not None:
        user_train = Path(project_path) / "user_train"
        if user_train.is_dir():
            matches = sorted(
                user_train.glob(f"{region_path.name}_poly_*.gpkg")
            )
            if matches:
                return done(
                    read_gpkg(matches[0], class_column=class_column)
                )
        shared = Path(project_path) / "polygons.geojson"
        if shared.is_file():
            shapes = parse_geojson(shared, class_column=class_column)
            if bounds is not None:
                shapes = filter_by_bounds(shapes, bounds)
            return done(shapes)
    return None


# ---------------------------------------------------------------------------
# GeoPackage (gpkg) reading: stdlib sqlite3 + a WKB polygon parser — the
# reference's training vectors (user_train/*.gpkg, geopandas/GEOS there).
# ---------------------------------------------------------------------------


def _parse_wkb_rings(wkb: bytes) -> T.List[Ring]:
    """Exterior rings from WKB Polygon / MultiPolygon (2D or with Z/M)."""

    def parse_geometry(buf: memoryview, pos: int) -> T.Tuple[T.List[Ring], int]:
        bo = "<" if buf[pos] == 1 else ">"
        (gtype,) = struct.unpack_from(bo + "I", buf, pos + 1)
        pos += 5
        base = gtype & 0xFF
        ndim = 2
        flat = gtype % 1000
        if gtype & 0x80000000:  # EWKB Z flag
            ndim += 1
        if gtype & 0x40000000:  # EWKB M flag
            ndim += 1
        if 1000 <= (gtype & 0xFFFF) < 2000:
            ndim = 3
        elif 2000 <= (gtype & 0xFFFF) < 3000:
            ndim = 3
        elif 3000 <= (gtype & 0xFFFF) < 4000:
            ndim = 4
        if gtype & 0x20000000:  # EWKB SRID present
            pos += 4
        base = flat if flat in (3, 6, 7) else base

        if base == 3:  # Polygon
            (n_rings,) = struct.unpack_from(bo + "I", buf, pos)
            pos += 4
            rings: T.List[Ring] = []
            for ring_i in range(n_rings):
                (n_pts,) = struct.unpack_from(bo + "I", buf, pos)
                pos += 4
                pts = np.frombuffer(
                    buf, dtype=np.dtype("f8").newbyteorder(bo),
                    count=n_pts * ndim, offset=pos,
                ).reshape(n_pts, ndim)
                pos += n_pts * ndim * 8
                if ring_i == 0:  # exterior only (holes unused in label math)
                    rings.append(np.asarray(pts[:, :2], dtype="float64"))
            return rings, pos
        if base in (6, 7):  # MultiPolygon / GeometryCollection
            (n_geoms,) = struct.unpack_from(bo + "I", buf, pos)
            pos += 4
            rings = []
            for _ in range(n_geoms):
                sub, pos = parse_geometry(buf, pos)
                rings.extend(sub)
            return rings, pos
        return [], pos

    rings, _ = parse_geometry(memoryview(wkb), 0)
    return rings


def _strip_gpkg_header(blob: bytes) -> bytes:
    """GeoPackage geometry BLOB -> inner WKB (GP header + envelope)."""
    if blob[:2] != b"GP":
        return blob  # plain WKB
    flags = blob[3]
    envelope_code = (flags >> 1) & 0x7
    envelope_len = {0: 0, 1: 32, 2: 48, 3: 48, 4: 64}.get(envelope_code, 0)
    return blob[8 + envelope_len :]


def read_gpkg(
    path: T.Union[str, Path],
    class_column: T.Optional[str] = None,
) -> Shapes:
    """(exterior ring, class value) pairs from a GeoPackage feature table
    (pure python: stdlib sqlite3 + WKB parsing — the reference reads these
    with geopandas/fiona)."""
    con = sqlite3.connect(str(path))
    try:
        cur = con.cursor()
        tables = cur.execute(
            "SELECT table_name FROM gpkg_contents WHERE data_type='features'"
        ).fetchall()
        if not tables:
            raise ValueError(f"No feature tables in {path}")
        table = tables[0][0]
        (geom_col,) = cur.execute(
            "SELECT column_name FROM gpkg_geometry_columns "
            "WHERE table_name=?",
            (table,),
        ).fetchone()
        columns = [
            row[1]
            for row in cur.execute(f"PRAGMA table_info('{table}')").fetchall()
        ]
        if class_column is None:
            class_column = next(
                (c for c in columns if c.lower() in _CLASS_KEYS_LOWER), None
            )
        select_cols = f'"{geom_col}"' + (
            f', "{class_column}"' if class_column else ""
        )
        shapes: Shapes = []
        for row in cur.execute(f'SELECT {select_cols} FROM "{table}"'):
            blob = row[0]
            if blob is None:
                continue
            value = 1
            if class_column:
                try:
                    value = int(row[1])
                except (TypeError, ValueError):
                    value = 1
            for ring in _parse_wkb_rings(_strip_gpkg_header(bytes(blob))):
                shapes.append((ring, value))
        return shapes
    finally:
        con.close()


def points_in_ring(points: np.ndarray, ring: Ring) -> np.ndarray:
    """Vectorized ray-casting point-in-polygon: (N, 2) points against one
    exterior ring -> (N,) bool (the centroid-in-partition test the
    reference does with geopandas overlay, datasets.py:211-214)."""
    points = np.asarray(points, dtype="float64")
    x, y = points[:, 0], points[:, 1]
    x0, y0 = ring[:-1, 0], ring[:-1, 1]
    x1, y1 = ring[1:, 0], ring[1:, 1]
    inside = np.zeros(len(points), dtype=bool)
    for ax, ay, bx, by in zip(x0, y0, x1, y1):
        crosses = (ay > y) != (by > y)
        with np.errstate(divide="ignore", invalid="ignore"):
            xint = ax + (y - ay) / (by - ay) * (bx - ax)
        inside ^= crosses & (x < xint)
    return inside
