"""Train-chip creation in the port (``data/create.py::create_train_batch``,
``data/vector.py``, ``data/geotiff.py::read_time_series``,
``utils/model_preprocessing.py``) against the JAX package, on the CPU.

- ``create_train_batch`` writes the JAX package's chip for every knob
  (``keep_crop_classes``, ``nonag_is_unknown``, ``all_touched``,
  ``zero_padding``, ``grid_size``, ``compression``, ``overwrite``, no
  polygons): the same file name and arrays, x and bdist within one
  float32 ulp (measured: equal), y, bounds and ``batch_id`` equal; the
  ``grid_size`` refusal. cv2 runs its own distance code
  (``cv2.ipp.setUseIPP(False)``; see ``test_torch_label_math.py``).
- ``read_region_polygons`` from each of its five sources in the JAX order
  (polygons.json, GeoJSON, GeoPackage, ``user_train`` GeoPackage,
  project-wide GeoJSON clipped to the region's bounds), with
  ``class_column`` and ``replace_dict``; ``points_in_ring``.
- ``read_time_series`` (mixed resolution, the seasonal window,
  ``skip_index``, ``var_dirs``), ``resample_frame`` and
  ``get_time_series_list`` equal JAX's.
- The port's ``create`` runs with ``cv2`` and ``yaml`` blocked, and a
  project ``config.yml`` without PyYAML raises naming the file.
"""

import json
import sqlite3
import struct
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from cultionet_tpu.data import create as jax_create  # noqa: E402
from cultionet_tpu.data import geotiff as jax_geotiff  # noqa: E402
from cultionet_tpu.data import vector as jax_vector  # noqa: E402
from cultionet_tpu.utils import model_preprocessing as jax_mp  # noqa: E402
from cultionet_tpu_torch.data import create as port_create  # noqa: E402
from cultionet_tpu_torch.data import geotiff as port_geotiff  # noqa: E402
from cultionet_tpu_torch.data import vector as port_vector  # noqa: E402
from cultionet_tpu_torch.data.tiny_tiff import write_tiff  # noqa: E402
from cultionet_tpu_torch.utils import model_preprocessing as port_mp  # noqa: E402

from test_torch_label_math import seeded_shapes, ulps  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def opencv_own_code():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


def scene(seed, shape=(5, 48, 52, 3)):
    """A seeded int16 x 10000 scene with zeros and NaN-free gaps."""
    rng = np.random.default_rng(seed)
    x = (rng.random(shape) * 10000).astype("int16")
    x[rng.random(shape) < 0.05] = 0
    return x


BOUNDS = (300_000.0, 5_000_000.0, 300_520.0, 5_000_480.0)  # 10 m cells


def assert_chips_equal(got: Path, want: Path) -> None:
    assert got.name == want.name
    with np.load(got) as g, np.load(want) as w:
        assert sorted(g.files) == sorted(w.files)
        for key in w.files:
            assert g[key].dtype == w[key].dtype, key
            assert g[key].shape == w[key].shape, key
            if key in ("x", "bdist"):
                assert ulps(g[key], w[key]) <= 1, key
            else:
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)


KNOBS = {
    "default": {},
    "keep_crop_classes": dict(keep_crop_classes=True, max_crop_class=4),
    "nonag_is_unknown": dict(nonag_is_unknown=True),
    "all_touched_off": dict(all_touched=False),
    "zero_padding": dict(zero_padding=3),
    "grid_size": dict(grid_size=(48, 52)),
    "compression_none": dict(compression="none"),
    "gain_offset": dict(gain=2e-4, offset=0.01, start_date="2020-01-01",
                        end_date="2020-12-31"),
}


@pytest.mark.parametrize("knob", list(KNOBS))
def test_create_train_batch_matches_jax(tmp_path, knob):
    kwargs = KNOBS[knob]
    rng = np.random.default_rng(len(knob))
    shapes = seeded_shapes(
        rng, BOUNDS, 14, max_value=kwargs.get("max_crop_class", 1)
    )
    common = dict(
        image_time_series=scene(len(knob)),
        polygons=shapes,
        bounds=BOUNDS,
        cell_res=10.0,
        region="r7",
        **kwargs,
    )
    got = port_create.create_train_batch(process_path=tmp_path / "port", **common)
    want = jax_create.create_train_batch(process_path=tmp_path / "jax", **common)
    assert_chips_equal(got, want)
    with np.load(got) as data:
        labels = data["y"]
    assert (labels == kwargs.get("max_crop_class", 1) + 1).any()  # edges
    if knob == "nonag_is_unknown":
        assert (labels == -1).any()


def test_create_train_batch_without_polygons(tmp_path):
    for unknown in (False, True):
        common = dict(
            image_time_series=scene(3), polygons=None, bounds=BOUNDS,
            cell_res=10.0, region=f"empty{unknown}", nonag_is_unknown=unknown,
        )
        assert_chips_equal(
            port_create.create_train_batch(process_path=tmp_path / "p", **common),
            jax_create.create_train_batch(process_path=tmp_path / "j", **common),
        )


def test_create_train_batch_grid_size_and_overwrite(tmp_path):
    common = dict(
        image_time_series=scene(4), polygons=seeded_shapes(
            np.random.default_rng(4), BOUNDS, 5
        ),
        bounds=BOUNDS, cell_res=10.0, region="r1", process_path=tmp_path,
    )
    with pytest.raises(ValueError, match="grid-size"):
        port_create.create_train_batch(grid_size=(48, 50), **common)
    first = port_create.create_train_batch(**common)
    assert port_create.is_grid_processed(tmp_path, ["none"], "r1", "0", "1")
    assert port_create.create_train_batch(**common) is None
    mtime = first.stat().st_mtime_ns
    assert port_create.create_train_batch(overwrite=True, **common) == first
    assert first.stat().st_mtime_ns >= mtime


def test_prepare_image_time_series_fill_zeros_matches_jax():
    x = scene(9).astype(np.float64)
    x[0, :3, :3] = np.nan
    # Records above 2 take the gain; reflectances in [0, 1] do not.
    for series, kwargs in (
        (x, {}),
        (x * 1e-4, {}),
        (x, dict(offset=0.02)),
    ):
        np.testing.assert_array_equal(
            port_create.prepare_image_time_series(
                series, fill_zeros=True, **kwargs
            ),
            jax_create.prepare_image_time_series(
                series, fill_zeros=True, **kwargs
            ),
        )


# ---------------------------------------------------------------------------
# Polygon sources
# ---------------------------------------------------------------------------


def _wkb_polygon(rings, big_endian=False):
    order = ">" if big_endian else "<"
    out = struct.pack(order + "BII", 0 if big_endian else 1, 3, len(rings))
    for ring in rings:
        out += struct.pack(order + "I", len(ring))
        out += np.asarray(ring, dtype=np.dtype("f8").newbyteorder(order)).tobytes()
    return out


def write_gpkg(path: Path, features, class_column="class") -> None:
    """A minimal GeoPackage: one feature table of Polygon / MultiPolygon
    geometries (GP header, an XY envelope on the first) and a class
    column."""
    con = sqlite3.connect(str(path))
    cur = con.cursor()
    cur.execute(
        "CREATE TABLE gpkg_contents (table_name TEXT, data_type TEXT)"
    )
    cur.execute(
        "CREATE TABLE gpkg_geometry_columns (table_name TEXT, column_name TEXT)"
    )
    cur.execute("INSERT INTO gpkg_contents VALUES ('fields', 'features')")
    cur.execute("INSERT INTO gpkg_geometry_columns VALUES ('fields', 'geom')")
    cur.execute(f'CREATE TABLE fields (fid INTEGER, geom BLOB, "{class_column}" INTEGER)')
    for i, (polys, value) in enumerate(features):
        if len(polys) == 1:
            wkb = _wkb_polygon(polys[0], big_endian=i % 2 == 1)
        else:
            wkb = struct.pack("<BII", 1, 6, len(polys)) + b"".join(
                _wkb_polygon(p) for p in polys
            )
        flags = 0b00000011 if i == 0 else 0b00000001  # envelope on the first
        header = b"GP" + bytes([0, flags]) + struct.pack("<i", 32615)
        if i == 0:
            xy = np.concatenate([np.asarray(r) for p in polys for r in p])
            header += struct.pack("<4d", xy[:, 0].min(), xy[:, 0].max(),
                                  xy[:, 1].min(), xy[:, 1].max())
        cur.execute("INSERT INTO fields VALUES (?, ?, ?)", (i, header + wkb, value))
    con.commit()
    con.close()


def _ring(x0, y0, size):
    return [[x0, y0], [x0 + size, y0], [x0 + size, y0 + size], [x0, y0 + size], [x0, y0]]


def _feature(ring, props):
    return {"type": "Feature", "properties": props,
            "geometry": {"type": "Polygon", "coordinates": [ring]}}


def _make_sources(root: Path):
    """One region directory per source (and a project-wide GeoJSON)."""
    project = root / "project"
    regions = {}
    native = project / "time_series_vars" / "json"
    native.mkdir(parents=True)
    (native / "polygons.json").write_text(
        json.dumps([[_ring(1, 1, 5), 61], [_ring(9, 2, 4.5), 141]])
    )
    regions["json"] = native
    geo = project / "time_series_vars" / "geojson"
    geo.mkdir(parents=True)
    (geo / "polygons.geojson").write_text(json.dumps({
        "type": "FeatureCollection",
        "features": [
            _feature(_ring(1, 1, 5), {"class": 2, "cdl": 61}),
            {"type": "Feature", "properties": {"crop_class": 3},
             "geometry": {"type": "MultiPolygon", "coordinates": [
                 [_ring(10, 10, 3)], [_ring(20, 2, 2)]]}},
        ],
    }))
    regions["geojson"] = geo
    gpkg = project / "time_series_vars" / "gpkg"
    gpkg.mkdir(parents=True)
    write_gpkg(gpkg / "polygons.gpkg", [
        ([[_ring(1, 1, 5)]], 4), ([[_ring(7, 7, 2)], [_ring(12, 1, 3)]], 61),
        ([[_ring(3, 9, 4)]], 5),
    ])
    regions["gpkg"] = gpkg
    user = project / "time_series_vars" / "ut"
    user.mkdir(parents=True)
    (project / "user_train").mkdir()
    write_gpkg(project / "user_train" / "ut_poly_2021.gpkg",
               [([[_ring(2, 2, 6)]], 7)], class_column="DN")
    regions["user_train"] = user
    shared = project / "time_series_vars" / "shared"
    shared.mkdir(parents=True)
    (project / "polygons.geojson").write_text(json.dumps({
        "type": "FeatureCollection",
        "features": [
            _feature(_ring(1, 1, 5), {"value": 1}),
            _feature(_ring(500, 500, 5), {"value": 2}),  # outside the bounds
            _feature(_ring(18, 18, 5), {"value": 3}),  # straddles them
        ],
    }))
    regions["shared"] = shared
    return project, regions


def _same_shapes(got, want):
    assert (got is None) == (want is None)
    if want is None:
        return
    assert len(got) == len(want)
    for (g_ring, g_value), (w_ring, w_value) in zip(got, want):
        assert g_value == w_value
        np.testing.assert_array_equal(g_ring, w_ring)


@pytest.mark.parametrize("source", ["json", "geojson", "gpkg", "user_train", "shared"])
@pytest.mark.parametrize(
    "kwargs",
    [{}, dict(class_column="cdl"), dict(replace_dict={61: 1, 7: 0})],
    ids=["auto", "class_column", "replace_dict"],
)
def test_read_region_polygons_matches_jax(tmp_path, source, kwargs):
    project, regions = _make_sources(tmp_path)
    bounds = (0.0, 0.0, 20.0, 20.0)
    got = port_vector.read_region_polygons(
        regions[source], bounds=bounds, project_path=project, **kwargs
    )
    want = jax_vector.read_region_polygons(
        regions[source], bounds=bounds, project_path=project, **kwargs
    )
    assert want
    _same_shapes(got, want)
    if source == "shared":
        assert len(got) == 2  # the far polygon is clipped away


def test_points_in_ring_matches_jax():
    rng = np.random.default_rng(0)
    points = rng.uniform(0, 12, (200, 2))
    ring = np.asarray(_ring(2, 3, 6) [:-1] + [[5, 11], [2, 3]], dtype=np.float64)
    np.testing.assert_array_equal(
        port_vector.points_in_ring(points, ring),
        jax_vector.points_in_ring(points, ring),
    )


# ---------------------------------------------------------------------------
# GeoTIFF time series
# ---------------------------------------------------------------------------


def _write_series(region: Path, rng) -> None:
    """Two 10 m bands and one 20 m band, dated %Y%j across two years."""
    bounds = (500_000.0, 4_000_000.0, 500_400.0, 4_000_400.0)
    dates = ["2020300", "2021001", "2021032", "2021100", "2021200", "2021350"]
    for var, size in (("b02", 40), ("b03", 40), ("b11", 20)):
        (region / var).mkdir(parents=True)
        for date in dates:
            write_tiff(
                region / var / f"{date}.tif",
                (rng.random((size, size)) * 10000).astype("uint16"),
                bounds=bounds, crs="EPSG:32615",
            )


@pytest.mark.parametrize(
    "kwargs",
    [
        {},
        dict(ref_res=10.0, resampling="bilinear"),
        dict(ref_res=20.0),
        dict(end_year=2021, start_mmdd="01-01", end_mmdd="06-30"),
        dict(end_year=2021, start_mmdd="10-01", end_mmdd="04-30", num_months=3),
        dict(skip_index=2),
        dict(end_year=2021, start_mmdd="01-01", end_mmdd="12-31",
             date_format="%Y%j", skip_index=2),
    ],
    ids=["plain", "ref10_bilinear", "ref20", "season", "season_cross_year",
         "skip", "season_skip"],
)
def test_read_time_series_matches_jax(tmp_path, kwargs):
    region = tmp_path / "region"
    _write_series(region, np.random.default_rng(0))
    got = port_geotiff.read_time_series(region, **kwargs)
    want = jax_geotiff.read_time_series(region, **kwargs)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == want[0].dtype
    assert got[1:] == want[1:]


def test_read_time_series_var_dirs_matches_jax(tmp_path):
    region = tmp_path / "region"
    _write_series(region, np.random.default_rng(1))
    var_dirs = [region / "b11", region / "b02"]
    got = port_geotiff.read_time_series(region, var_dirs=var_dirs)
    want = jax_geotiff.read_time_series(region, var_dirs=var_dirs)
    np.testing.assert_array_equal(got[0], want[0])
    with pytest.raises(FileNotFoundError):
        port_geotiff.read_time_series(region, var_dirs=[region / "nope"])


@pytest.mark.parametrize("method", ["nearest", "bilinear"])
@pytest.mark.parametrize("dtype", ["uint16", "float32"])
def test_resample_frame_matches_jax(method, dtype):
    frame = (np.random.default_rng(2).random((13, 17)) * 1000).astype(dtype)
    for shape in ((26, 34), (7, 9), (13, 17), (20, 11)):
        got = port_geotiff.resample_frame(frame, shape, method)
        want = jax_geotiff.resample_frame(frame, shape, method)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_get_time_series_list_matches_jax(tmp_path):
    for name in ("2020350", "2021001", "20210215", "2021-03-01", "202104",
                 "2021190", "notadate", "2021365"):
        (tmp_path / f"{name}.tif").touch()
    (tmp_path / "2021050.npy").touch()
    for args in (
        (2021, "01-01", "12-31"), (2021, "12-01", "03-01"), (2021, "02-01", "07-31", 2),
    ):
        assert port_mp.get_time_series_list(tmp_path, *args) == (
            jax_mp.get_time_series_list(tmp_path, *args)
        )
    assert port_mp.get_time_series_list(tmp_path, 2021, "01-01", "12-31",
                                        date_format="%Y-%m-%d") == (
        jax_mp.get_time_series_list(tmp_path, 2021, "01-01", "12-31",
                                    date_format="%Y-%m-%d")
    )


# ---------------------------------------------------------------------------
# No OpenCV, no PyYAML
# ---------------------------------------------------------------------------


def test_create_runs_without_cv2_and_yaml(tmp_path):
    """The port's ``create`` (label math, chips) with ``cv2`` and ``yaml``
    blocked in ``sys.modules``: what the card machine needs."""
    from test_cli import make_project

    project = make_project(tmp_path, num_regions=2)
    code = textwrap.dedent(
        f"""
        import sys
        sys.modules["cv2"] = None
        sys.modules["yaml"] = None
        from cultionet_tpu_torch.scripts.cli import main
        main(["create", "-p", {str(project)!r}, "--num-workers", "1"],
             device="cpu")
        print("ok")
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr
    chips = sorted((project / "data/train/processed").glob("*.npz"))
    assert [c.name for c in chips] == [
        "data_000000_0_1_none.npz", "data_000001_0_1_none.npz"
    ]


def test_project_config_without_yaml_raises(tmp_path, monkeypatch):
    from test_cli import make_project

    from cultionet_tpu_torch.scripts.cli import main

    project = make_project(tmp_path, num_regions=1)
    (project / "config.yml").write_text("regions: ['000000']\n")
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(RuntimeError, match="config.yml"):
        main(["create", "-p", str(project)], device="cpu")


def test_load_scene_feature_pattern_matches_jax(tmp_path):
    """The CLI's scene loader over ``--feature-pattern`` variable
    directories ('{region}/brdf_ts/ms/{image_vi}') and a seasonal window."""
    from cultionet_tpu.scripts import cli as jax_cli
    from cultionet_tpu_torch.scripts import cli as port_cli

    root = tmp_path / "time_series_vars"
    region = root / "r1"
    _write_series(region / "brdf_ts" / "ms", np.random.default_rng(3))
    kwargs = dict(
        feature_pattern="{region}/brdf_ts/ms/{image_vi}",
        image_vis=["b11", "b02"],
        window=dict(end_year=2021, start_mmdd="01-01", end_mmdd="12-31",
                    num_months=4),
        skip_index=1,
    )
    got = port_cli.load_scene(region, **kwargs)
    want = jax_cli.load_scene(region, **kwargs)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].shape == (4, 20, 20, 2)  # onto the first band's (20 m) grid
    assert got[1:4] == want[1:4] and got[4] is want[4] is None
    with pytest.raises(ValueError, match="image_vis"):
        port_cli.load_scene(region, feature_pattern="{region}/x/{image_vi}")
