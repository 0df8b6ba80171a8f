"""Raster label engineering in numpy and scipy: polygon burn-in, edge
extraction, boundary distances (port of cultionet_tpu/data/label_math.py).

The JAX package computes these with OpenCV. The port reproduces OpenCV's
results, not an idealised version of them, without importing it:

- ``polygons_to_array``: ``cv2.fillPoly`` on rounded integer vertices, which
  draws every edge as an 8-connected line and then fills the scanlines
  between the edges' 16.16 fixed-point crossings (``_fill_poly``); holes
  are filled back to 0 the same way. The rules were read off cv2's output
  on drawn polygons (``tests/test_torch_label_math.py`` holds them).
- ``edge_gradient``: ``MORPH_GRADIENT`` with a 2 x 2 kernel anchored at
  (1, 1); pixels outside the image are ignored.
- ``create_boundary_distances``: ``cv2.distanceTransform(DIST_L2, 3)``, a
  3 x 3 chamfer transform (steps 0.955 and 1.3693) in OpenCV's 16.16 fixed
  point, with pixels outside the image not zeros (``chamfer_distance``).

Not ported: the Sobel orientation of ``create_boundary_distances`` and
``merge_distances`` (nothing on the chip-creation path reads them).
"""

import typing as T

import numpy as np
from scipy import ndimage


def _roll_trim(arr_pad: np.ndarray, shift: int, axis: int) -> np.ndarray:
    return np.roll(arr_pad, shift, axis=axis)[1:-1, 1:-1]


def _neighbor_count(
    array: np.ndarray, predicate: T.Callable[[np.ndarray], np.ndarray]
) -> np.ndarray:
    """Count of the 4 rook neighbors satisfying ``predicate`` (edge-padded)."""
    array_pad = np.pad(array, 1, mode="edge")
    count = np.zeros(array.shape, dtype=np.uint8)
    for shift, axis in ((1, 0), (-1, 0), (1, 1), (-1, 1)):
        count += predicate(_roll_trim(array_pad, shift, axis)).astype(np.uint8)
    return count


def get_crop_count(array: np.ndarray, edge_class: int) -> np.ndarray:
    return _neighbor_count(array, lambda r: (r > 0) & (r != edge_class))


def get_edge_count(array: np.ndarray, edge_class: int) -> np.ndarray:
    return _neighbor_count(array, lambda r: r == edge_class)


def get_non_count(array: np.ndarray) -> np.ndarray:
    return _neighbor_count(array, lambda r: r == 0)


def cleanup_edges(
    array: np.ndarray, original: np.ndarray, edge_class: int
) -> np.ndarray:
    """Edge cleanup rules: fill edge gaps, remove crop pixels touching
    non-crop across an edge, restore all-non-crop pixels, drop isolated
    crop clumps."""
    original_zero = get_non_count(original)

    array = np.where(
        (array == 0)
        & (get_crop_count(array, edge_class) > 0)
        & (get_edge_count(array, edge_class) > 0),
        edge_class,
        array,
    )
    array = np.where(
        (array > 0)
        & (array != edge_class)
        & (get_non_count(array) > 0)
        & (get_edge_count(array, edge_class) > 0),
        0,
        array,
    )
    array = np.where(original_zero == 4, 0, array)
    array = np.where(
        (array > 0)
        & (array != edge_class)
        & (get_crop_count(array, edge_class) <= 1)
        & (get_edge_count(array, edge_class) <= 1),
        0,
        array,
    )
    return array


def edge_gradient(array: np.ndarray) -> np.ndarray:
    """1 where the morphological gradient (2 x 2 dilation minus erosion) of
    the uint8 view of ``array`` is non-zero.

    OpenCV anchors the 2 x 2 kernel at (1, 1), so pixel (r, c) sees
    (r-1..r, c-1..c), and ignores pixels outside the image. Like
    ``np.uint8(array)`` in the JAX function, values wrap modulo 256.
    """
    a = np.uint8(array)
    lo = np.pad(a, ((1, 0), (1, 0)), constant_values=255)
    hi = np.pad(a, ((1, 0), (1, 0)), constant_values=0)
    window = ((slice(0, -1), slice(0, -1)), (slice(0, -1), slice(1, None)),
              (slice(1, None), slice(0, -1)), (slice(1, None), slice(1, None)))
    erode = np.minimum.reduce([lo[w] for w in window])
    dilate = np.maximum.reduce([hi[w] for w in window])
    return np.uint8(dilate != erode)


# ---------------------------------------------------------------------------
# Chamfer distance (cv2.distanceTransform with DIST_L2 and a 3 x 3 mask)
# ---------------------------------------------------------------------------

# OpenCV's chamfer steps in 16.16 fixed point (cvRound(0.955f * 2^16) and
# cvRound(1.3693f * 2^16)); its image border and saturation value.
_HV_DIST = 62587
_DIAG_DIST = 89738
_DIST_MAX = 0xFFFFFFFF - _DIAG_DIST


def _chamfer_scan(init: np.ndarray, sources: np.ndarray) -> np.ndarray:
    """One raster scan of the 3 x 3 chamfer from the top row down, in int64
    16.16 fixed point: each pixel takes the least of ``init``, the row
    above's three neighbors plus their steps and the left neighbor plus
    HV; sources are 0. The left-to-right chain d[j] = min(c[j], d[j-1] +
    HV) is a cumulative minimum, d[j] = j HV + min_k<=j (c[k] - k HV).
    Pixels outside the image hold ``_DIST_MAX``."""
    height, width = sources.shape
    ramp = np.arange(width + 1, dtype=np.int64) * _HV_DIST
    out = np.empty((height, width), dtype=np.int64)
    up = np.full(width + 2, _DIST_MAX, dtype=np.int64)
    chain = np.empty(width + 1, dtype=np.int64)
    for i in range(height):
        cand = np.minimum(up[:-2] + _DIAG_DIST, up[1:-1] + _HV_DIST)
        np.minimum(cand, up[2:] + _DIAG_DIST, out=cand)
        np.minimum(cand, init[i], out=cand)
        cand[sources[i]] = 0
        chain[0] = _DIST_MAX
        chain[1:] = cand
        chain -= ramp
        np.minimum.accumulate(chain, out=chain)
        chain += ramp
        out[i] = chain[1:]
        up[1:-1] = out[i]
    return out


def chamfer_distance(mask: np.ndarray) -> np.ndarray:
    """float32 distance of each non-zero pixel of ``mask`` to the nearest
    zero pixel, as OpenCV's own ``cv2.distanceTransform(mask, DIST_L2, 3)``
    computes it: a forward and a backward raster scan of the 3 x 3 chamfer
    with steps 0.955 (rook) and 1.3693 (diagonal) in 16.16 fixed point,
    saturated at 2^32 - 1 - 89738 and scaled to float32. Pixels outside the
    image are not zeros, so a mask without a zero is 65534.63 everywhere.

    cv2 hands this call to Intel IPP where its build has IPP, whose float32
    arithmetic differs from OpenCV's own code in the last digits;
    ``cv2.ipp.setUseIPP(False)`` selects OpenCV's code.
    """
    sources = np.asarray(mask) == 0
    never = np.full(sources.shape, _DIST_MAX, dtype=np.int64)
    forward = _chamfer_scan(never, sources)
    # The backward scan is the forward scan of the image turned by 180
    # degrees, started from the forward distances.
    backward = _chamfer_scan(forward[::-1, ::-1], sources[::-1, ::-1])
    dist = np.minimum(backward[::-1, ::-1], _DIST_MAX)
    return dist.astype(np.float32) * np.float32(1.0 / (1 << 16))


def create_boundary_distances(
    labels_array: np.ndarray, train_type: str, cell_res: float
) -> T.Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The uint8 mask, its connected segments and the distance of each mask
    pixel from the mask's boundary, times ``cell_res`` (the JAX function's
    first three results; its Sobel orientation is not ported)."""
    if train_type.lower() == "polygon":
        mask = np.uint8(labels_array)
    else:
        mask = np.uint8(1 - labels_array)

    segments = ndimage.label(mask)[0]
    bdist = chamfer_distance(mask)
    bdist *= cell_res
    return mask, segments, bdist


def normalize_boundary_distances(
    labels_array: np.ndarray,
    train_type: str,
    cell_res: float,
    normalize: bool = True,
) -> np.ndarray:
    """Boundary distances divided by their segment's maximum (the JAX
    function's first result; its orientation is not ported)."""
    _, segments, bdist = create_boundary_distances(
        labels_array, train_type, cell_res
    )
    dist_max = 1e9
    if normalize:
        dist_max = 1.0
        num_segments = int(segments.max())
        if num_segments > 0:
            seg_max = ndimage.maximum(
                bdist, labels=segments, index=np.arange(1, num_segments + 1)
            )
            seg_max = np.concatenate(([1.0], np.asarray(seg_max)))
            divisor = seg_max[segments]
            with np.errstate(divide="ignore", invalid="ignore"):
                bdist = np.where(segments > 0, bdist / divisor, bdist)

    return np.nan_to_num(
        bdist.clip(0, dist_max), nan=1.0, neginf=1.0, posinf=1.0
    )


def fillz(x: np.ndarray) -> np.ndarray:
    """Fill zeros with the 3x3 focal mean over (H, W) of a (T, C, H, W) or
    (..., H, W) stack."""
    size = (1,) * (x.ndim - 2) + (3, 3)
    focal_mean = ndimage.uniform_filter(x, size=size, mode="reflect")
    return np.where(x == 0, focal_mean, x)


# ---------------------------------------------------------------------------
# Polygon rasterization (cv2.fillPoly and cv2.polylines)
# ---------------------------------------------------------------------------

_XY_SHIFT = 16
_XY_CEIL = (1 << _XY_SHIFT) - 1


def _clip_line(
    width: int, height: int, x1: int, y1: int, x2: int, y2: int
) -> T.Tuple[bool, int, int, int, int]:
    """OpenCV's ``clipLine`` on the image rectangle: move each endpoint
    outside the image along the line onto its border, the offsets truncated
    from double arithmetic, the second endpoint using the first's moved
    coordinates. Returns (inside, x1, y1, x2, y2)."""
    right, bottom = width - 1, height - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _inside(width: int, height: int, x: int, y: int) -> bool:
    return 0 <= x < width and 0 <= y < height


def _draw_line(
    out: np.ndarray, x1: int, y1: int, x2: int, y2: int, value
) -> None:
    """OpenCV's 8-connected line (``LineIterator``, left to right): clipped
    to the image, the major axis steps every pixel and the minor axis
    steps where the Bresenham error (starting at D - 2d) is negative."""
    height, width = out.shape
    if not (_inside(width, height, x1, y1) and _inside(width, height, x2, y2)):
        inside, x1, y1, x2, y2 = _clip_line(width, height, x1, y1, x2, y2)
        if not inside:
            return
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    step_y = -1 if dy < 0 else 1
    dy = abs(dy)
    major, minor = (dy, dx) if dy > dx else (dx, dy)
    k = np.arange(major + 1, dtype=np.int64)
    # Minor steps taken before pixel k: ceil((2 d k - D) / 2D).
    m = (2 * minor * k + major - 1) // (2 * major) if major else k
    if dy > dx:
        rows, cols = y1 + step_y * k, x1 + m
    else:
        rows, cols = y1 + step_y * m, x1 + k
    out[rows, cols] = value


def _collect_edges(
    pts: np.ndarray, width: int, height: int, out: np.ndarray, value
) -> T.List[T.Tuple[int, int, int, int]]:
    """Draw the closed ring's edges as 8-connected lines and return the
    scanline edges (y0, y1, x at y0 in 16.16 fixed point, dx per row, the
    division truncated) that OpenCV's ``CollectPolyEdges`` builds. An edge
    with an endpoint outside the image keeps its rows but takes its x from
    its clipped segment (only the x when that segment is flat)."""
    edges = []
    count = len(pts)
    x0, y0 = int(pts[-1][0]), int(pts[-1][1])
    for i in range(count):
        x1, y1 = int(pts[i][0]), int(pts[i][1])
        _draw_line(out, x0, y0, x1, y1, value)
        c0x, c0y, c1x, c1y = x0 << _XY_SHIFT, y0, x1 << _XY_SHIFT, y1
        if not (_inside(width, height, x0, y0) and _inside(width, height, x1, y1)):
            _, t0x, t0y, t1x, t1y = _clip_line(width, height, x0, y0, x1, y1)
            c0x, c1x = t0x << _XY_SHIFT, t1x << _XY_SHIFT
            if t0y != t1y:
                c0y, c1y = t0y, t1y
        if y0 != y1:
            num, den = c1x - c0x, c1y - c0y
            # C integer division truncates toward zero.
            step = abs(num) // abs(den) * (1 if (num < 0) == (den < 0) else -1)
            if y0 < y1:
                edges.append((y0, y1, c0x + (y0 - c0y) * step, step))
            else:
                edges.append((y1, y0, c1x + (y1 - c1y) * step, step))
        x0, y0 = x1, y1
    return edges


def _fill_poly(out: np.ndarray, pts: np.ndarray, value) -> None:
    """``cv2.fillPoly(out, [pts], value)`` (8-connected, no shift): the
    edges as lines, then every image row's spans between consecutive
    crossings of the edges active on it (y0 <= y < y1), sorted by x, from
    ceil(x_left) to floor(x_right) of their 16.16 fixed-point positions,
    clipped to the image."""
    height, width = out.shape
    edges = _collect_edges(pts, width, height, out, value)
    if len(edges) < 2:
        return
    e = np.asarray(edges, dtype=np.int64)
    y0, y1, x0, step = e[:, :1], e[:, 1:2], e[:, 2:3], e[:, 3:4]
    rows = np.arange(max(int(y0.min()), 0), min(int(y1.max()), height))
    if rows.size == 0:
        return
    active = (y0 <= rows) & (rows < y1)
    xs = np.where(active, x0 + (rows - y0) * step, np.iinfo(np.int64).max)
    xs.sort(axis=0)
    n_active = active.sum(axis=0)
    spans = np.zeros((rows.size, width + 1), dtype=np.int32)
    for k in range(0, len(edges) - 1, 2):
        left = (xs[k] + _XY_CEIL) >> _XY_SHIFT
        right = xs[k + 1] >> _XY_SHIFT
        ok = (k + 1 < n_active) & (left < width) & (right >= 0)
        r = np.nonzero(ok)[0]
        np.add.at(spans, (r, np.maximum(left[ok], 0)), 1)
        np.add.at(spans, (r, np.minimum(right[ok], width - 1) + 1), -1)
    filled = np.cumsum(spans, axis=1)[:, :width] > 0
    out[rows[0] : rows[-1] + 1][filled] = value


def world_to_pixel(
    coords: np.ndarray,
    bounds: T.Tuple[float, float, float, float],
    shape: T.Tuple[int, int],
) -> np.ndarray:
    """Map (N, 2) world (x, y) coords to fractional pixel (col, row)."""
    left, bottom, right, top = bounds
    nrows, ncols = shape
    cell_x = (right - left) / ncols
    cell_y = (top - bottom) / nrows
    cols = (coords[:, 0] - left) / cell_x
    rows = (top - coords[:, 1]) / cell_y
    return np.stack([cols, rows], axis=-1)


def polygons_to_array(
    shapes: T.Sequence[T.Tuple[T.Any, int]],
    bounds: T.Tuple[float, float, float, float],
    out_shape: T.Tuple[int, int],
    fill_value: int = 0,
    dtype: str = "uint8",
    all_touched: bool = True,
) -> np.ndarray:
    """Burn polygons into a raster.

    ``shapes`` is a sequence of (polygon, value) where polygon is either an
    (N, 2) array of exterior-ring world coordinates or a dict
    {"exterior": (N, 2), "holes": [(M, 2), ...]}. Each polygon is filled on
    its rounded pixel vertices, outline included, and its holes filled back
    to 0; later polygons overwrite earlier ones. ``all_touched`` is kept
    for the CLI's flag: the outline it adds is already in the fill. Values
    above 255 switch a uint8 raster to int32.
    """
    if dtype == "uint8" and shapes:
        if max(int(v) for _, v in shapes) > 255:
            dtype = "int32"
    out = np.full(out_shape, fill_value, dtype=dtype)

    for polygon, value in shapes:
        if isinstance(polygon, dict):
            exterior = np.asarray(polygon["exterior"], dtype=np.float64)
            holes = [
                np.asarray(h, dtype=np.float64)
                for h in polygon.get("holes", [])
            ]
        else:
            exterior = np.asarray(polygon, dtype=np.float64)
            holes = []

        mask = np.zeros(out_shape, dtype=np.uint8)
        ext_i32 = np.round(world_to_pixel(exterior, bounds, out_shape)).astype(
            np.int32
        )
        # The fill already holds every pixel of the 8-connected outline
        # that ``all_touched`` adds in cv2 (``polylines``), so it adds none.
        _fill_poly(mask, ext_i32, 1)
        for hole in holes:
            hole_px = world_to_pixel(hole, bounds, out_shape)
            _fill_poly(mask, np.round(hole_px).astype(np.int32), 0)
        out = np.where(mask > 0, np.asarray(value, dtype=dtype), out)

    return out
