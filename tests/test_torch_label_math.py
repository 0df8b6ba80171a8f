"""The port's label math (``cultionet_tpu_torch/data/label_math.py``, numpy
and scipy) against OpenCV and the JAX package (which calls OpenCV).

- ``_draw_line`` equals ``cv2.line`` and ``_fill_poly`` equals
  ``cv2.fillPoly`` bit for bit, on seeded segments and polygons inside the
  image, crossing its edges and far outside it.
- ``polygons_to_array``, ``edge_gradient`` and ``cleanup_edges`` equal the
  JAX functions exactly on seeded and hypothesis-drawn polygons: convex,
  concave, with holes, fractional vertices, off the image edge,
  ``all_touched`` on and off, class values above 255.
- ``chamfer_distance`` equals OpenCV's own ``distanceTransform(DIST_L2,
  3)`` bit for bit (``cv2.ipp.setUseIPP(False)``), and the port's
  ``normalize_boundary_distances`` the JAX one's first result within one
  float32 ulp (measured: equal), the all-crop and no-crop masks included.
  cv2 hands the transform to Intel IPP where its build has IPP; IPP's
  float32 arithmetic differs from OpenCV's fixed point by up to 5e-6
  relative on these masks, held to 1e-5.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

cv2 = pytest.importorskip("cv2")

from cultionet_tpu.data import label_math as jax_lm  # noqa: E402
from cultionet_tpu_torch.data import label_math as lm  # noqa: E402


@pytest.fixture
def opencv_own_code():
    """cv2 with its own code paths (not Intel IPP) for the test's span."""
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


def ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in float32 units in the last place."""
    a = np.ascontiguousarray(a, dtype=np.float32).view(np.int32).astype(np.int64)
    b = np.ascontiguousarray(b, dtype=np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


@pytest.mark.parametrize("span", [0, 10, 100, 100_000])
def test_draw_line_matches_cv2(span):
    rng = np.random.default_rng(span)
    for _ in range(400):
        height, width = (int(v) for v in rng.integers(1, 60, 2))
        x1, y1, x2, y2 = (
            int(v) for v in rng.integers(-span, max(height, width) + span, 4)
        )
        want = np.zeros((height, width), np.uint8)
        cv2.line(want, (x1, y1), (x2, y2), 1, 1)
        got = np.zeros((height, width), np.uint8)
        lm._draw_line(got, x1, y1, x2, y2, 1)
        np.testing.assert_array_equal(got, want, err_msg=str((x1, y1, x2, y2)))


@pytest.mark.parametrize("span", [0, 20, 1000, 100_000])
def test_fill_poly_matches_cv2(span):
    """Random (often self-intersecting) rings of 3-13 vertices; span 0 keeps
    every vertex inside the image."""
    rng = np.random.default_rng(100 + span)
    for _ in range(300):
        height, width = (int(v) for v in rng.integers(1, 70, 2))
        n = int(rng.integers(3, 14))
        pts = np.stack(
            [
                rng.integers(-span, width + span, n),
                rng.integers(-span, height + span, n),
            ],
            axis=1,
        ).astype(np.int32)
        want = np.zeros((height, width), np.uint8)
        cv2.fillPoly(want, [pts], 1)
        got = np.zeros((height, width), np.uint8)
        lm._fill_poly(got, pts, 1)
        np.testing.assert_array_equal(got, want, err_msg=str(pts.tolist()))


def _star(rng, center, radius, vertices):
    """A closed star-shaped (often concave) ring around ``center``."""
    angles = np.sort(rng.uniform(0, 2 * np.pi, vertices))
    radii = radius * rng.uniform(0.3, 1.0, vertices)
    ring = np.stack(
        [center[0] + radii * np.cos(angles), center[1] + radii * np.sin(angles)],
        axis=1,
    )
    return np.vstack([ring, ring[:1]])


def seeded_shapes(rng, bounds, count, max_value=3, hole_prob=0.4):
    """(polygon, class) pairs in world coordinates: star rings centred up to
    5 units outside ``bounds``, some with a hole (dict form)."""
    left, bottom, right, top = bounds
    shapes = []
    for _ in range(count):
        center = (rng.uniform(left - 5, right + 5), rng.uniform(bottom - 5, top + 5))
        radius = rng.uniform(1.0, 0.4 * (right - left))
        ring = _star(rng, center, radius, int(rng.integers(3, 12)))
        polygon = ring
        if rng.random() < hole_prob:
            hole = _star(rng, center, 0.3 * radius, 5)[::-1]
            polygon = {"exterior": ring, "holes": [hole]}
        shapes.append((polygon, int(rng.integers(1, max_value + 1))))
    return shapes


@pytest.mark.parametrize("all_touched", [True, False])
@pytest.mark.parametrize("max_value", [3, 400])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_polygons_to_array_matches_jax(seed, max_value, all_touched):
    rng = np.random.default_rng(seed)
    height, width = 57, 63
    bounds = (500_000.0, 4_000_000.0, 500_000.0 + 0.7 * width, 4_000_000.0 + 0.7 * height)
    shapes = seeded_shapes(rng, bounds, 12, max_value=max_value)
    got = lm.polygons_to_array(shapes, bounds, (height, width), all_touched=all_touched)
    want = jax_lm.polygons_to_array(
        shapes, bounds, (height, width), all_touched=all_touched
    )
    assert got.dtype == want.dtype == (np.int32 if max_value > 255 else np.uint8)
    np.testing.assert_array_equal(got, want)


def test_polygons_to_array_fill_value_matches_jax():
    rng = np.random.default_rng(7)
    bounds = (0.0, 0.0, 40.0, 30.0)
    shapes = seeded_shapes(rng, bounds, 6)
    kwargs = dict(fill_value=-1, dtype="int16")
    got = lm.polygons_to_array(shapes, bounds, (30, 40), **kwargs)
    want = jax_lm.polygons_to_array(shapes, bounds, (30, 40), **kwargs)
    assert got.dtype == want.dtype == np.int16
    np.testing.assert_array_equal(got, want)


coordinate = st.floats(-15.0, 55.0, allow_nan=False, width=32)
ring = st.lists(st.tuples(coordinate, coordinate), min_size=3, max_size=9)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(
    rings=st.lists(st.tuples(ring, st.integers(1, 300)), min_size=1, max_size=4),
    hole=st.one_of(st.none(), ring),
    all_touched=st.booleans(),
)
def test_polygons_to_array_hypothesis(rings, hole, all_touched):
    """Arbitrary rings (self-intersecting, degenerate, off the image) with
    fractional vertices, the first with an optional hole."""
    bounds = (0.0, 0.0, 40.0, 36.0)
    shapes = [(np.asarray(r + r[:1], dtype=np.float64), v) for r, v in rings]
    if hole is not None:
        shapes[0] = (
            {"exterior": shapes[0][0], "holes": [np.asarray(hole, np.float64)]},
            shapes[0][1],
        )
    got = lm.polygons_to_array(shapes, bounds, (36, 40), all_touched=all_touched)
    want = jax_lm.polygons_to_array(shapes, bounds, (36, 40), all_touched=all_touched)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("high", [2, 30, 600])
def test_edge_gradient_matches_jax(high):
    """Class values up to ``high`` (int32 above 255 wraps as np.uint8 does)."""
    rng = np.random.default_rng(high)
    for _ in range(50):
        height, width = (int(v) for v in rng.integers(1, 40, 2))
        array = rng.integers(0, high, (height, width)).astype(np.int32)
        array[rng.random((height, width)) < 0.5] = 0
        np.testing.assert_array_equal(
            lm.edge_gradient(array), jax_lm.edge_gradient(array)
        )


@settings(max_examples=40, deadline=None, derandomize=True)
@given(rings=st.lists(st.tuples(ring, st.integers(1, 300)), min_size=1, max_size=6))
def test_edge_gradient_and_cleanup_hypothesis(rings):
    """The instance raster's gradient and the edge clean-up, as
    ``ReferenceArrays.from_polygons`` chains them."""
    bounds = (0.0, 0.0, 40.0, 36.0)
    shapes = [(np.asarray(r + r[:1], dtype=np.float64), v) for r, v in rings]
    unique = [(poly, i + 1) for i, (poly, _) in enumerate(shapes)]
    instance = lm.polygons_to_array(unique, bounds, (36, 40))
    edges = lm.edge_gradient(instance)
    np.testing.assert_array_equal(edges, jax_lm.edge_gradient(instance))
    labels = lm.polygons_to_array(shapes, bounds, (36, 40)).astype(np.int16)
    labels = np.where(labels > 0, 1, 0).astype(np.int16)
    labels[edges == 1] = 2
    np.testing.assert_array_equal(
        lm.cleanup_edges(labels, instance, 2),
        jax_lm.cleanup_edges(labels, instance, 2),
    )


@pytest.mark.parametrize("edge_class", [2, 5])
def test_cleanup_edges_matches_jax(edge_class):
    rng = np.random.default_rng(edge_class)
    for _ in range(40):
        shape = tuple(int(v) for v in rng.integers(2, 40, 2))
        array = rng.integers(0, edge_class + 1, shape).astype(np.int16)
        original = rng.integers(0, 4, shape).astype(np.uint8)
        np.testing.assert_array_equal(
            lm.cleanup_edges(array, original, edge_class),
            jax_lm.cleanup_edges(array, original, edge_class),
        )
        for name in ("get_crop_count", "get_edge_count"):
            np.testing.assert_array_equal(
                getattr(lm, name)(array, edge_class),
                getattr(jax_lm, name)(array, edge_class),
            )
        np.testing.assert_array_equal(
            lm.get_non_count(array), jax_lm.get_non_count(array)
        )


def _masks(rng):
    """Random masks of every density, sparse-zero masks (long chains), and
    the no-zero (all crop) and all-zero masks."""
    out = [np.ones((17, 23), np.uint8), np.zeros((9, 5), np.uint8)]
    for _ in range(60):
        shape = tuple(int(v) for v in rng.integers(1, 90, 2))
        mask = (rng.random(shape) < rng.random()).astype(np.uint8)
        out.append(mask)
        sparse = np.ones(shape, np.uint8)
        sparse[rng.integers(0, shape[0]), rng.integers(0, shape[1])] = 0
        out.append(sparse)
    return out


def test_chamfer_distance_matches_opencv(opencv_own_code):
    rng = np.random.default_rng(11)
    for mask in _masks(rng):
        want = cv2.distanceTransform(mask, cv2.DIST_L2, 3)
        got = lm.chamfer_distance(mask)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_chamfer_distance_against_ipp():
    """cv2's default (Intel IPP where the build has it) differs from
    OpenCV's own fixed point only in the last digits. A mask without a
    zero is FLT_MAX in IPP and 65534.63 in OpenCV's code: both normalize
    to 1 (``test_normalize_boundary_distances_matches_jax``)."""
    rng = np.random.default_rng(12)
    for mask in _masks(rng):
        want = cv2.distanceTransform(mask, cv2.DIST_L2, 3)
        got = lm.chamfer_distance(mask)
        finite = want < 1e30
        np.testing.assert_allclose(got[finite], want[finite], rtol=1e-5, atol=0)


@pytest.mark.parametrize("cell_res", [1.0, 10.0, 0.3])
def test_normalize_boundary_distances_matches_jax(opencv_own_code, cell_res):
    rng = np.random.default_rng(int(cell_res * 10))
    bounds = (0.0, 0.0, 50.0, 44.0)
    labels = [np.ones((44, 50), np.uint8), np.zeros((44, 50), np.uint8)]
    for _ in range(8):
        burned = lm.polygons_to_array(seeded_shapes(rng, bounds, 10), bounds, (44, 50))
        labels.append((burned > 0).astype(np.uint8))
    for label in labels:
        for train_type in ("polygon", "boundary"):
            got = lm.normalize_boundary_distances(label, train_type, cell_res)
            want, _ = jax_lm.normalize_boundary_distances(label, train_type, cell_res)
            assert got.dtype == want.dtype
            assert ulps(got, want) <= 1
            _, segments, bdist = lm.create_boundary_distances(
                label, train_type, cell_res
            )
            _, jax_segments, jax_bdist, _ = jax_lm.create_boundary_distances(
                label, train_type, cell_res
            )
            np.testing.assert_array_equal(segments, jax_segments)
            assert ulps(bdist, jax_bdist) <= 1
    # The all-crop mask normalizes to 1 everywhere.
    np.testing.assert_array_equal(
        lm.normalize_boundary_distances(labels[0], "polygon", cell_res), 1.0
    )


def test_fillz_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.random((3, 2, 17, 21))
    x[rng.random(x.shape) < 0.3] = 0.0
    np.testing.assert_array_equal(lm.fillz(x), jax_lm.fillz(x))


def test_world_to_pixel_matches_jax():
    rng = np.random.default_rng(6)
    coords = rng.uniform(-10, 60, (40, 2))
    bounds = (-3.0, 2.0, 47.0, 51.0)
    np.testing.assert_array_equal(
        lm.world_to_pixel(coords, bounds, (33, 29)),
        jax_lm.world_to_pixel(coords, bounds, (33, 29)),
    )
