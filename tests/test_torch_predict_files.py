"""Predict over window chip files in the port (``data/create.py``,
``data/tiny_tiff.py``, ``data/geotiff.py``, ``utils/locks.py``,
``predict.py::predict_windows``/``predict_to_raster``,
``model.py::predict``) against the JAX package, fp32 on the CPU.

- ``create_predict_dataset`` writes the JAX package's files: the same
  names, arrays and dtypes, with one worker, threads or forked processes.
- The TIFF codec round-trips across the packages with bounds and CRS, and
  reads LZW (with the predictor), Deflate and PackBits files.
- The trained conv checkpoint ``tests/data/golden/ckpt`` (hidden 8, conv
  front end, T = 13) through the port: ``model.predict`` within 1e-4 of
  JAX's ``model.predict``, and the golden raster (>= 99.9% of the uint16
  pixels of ``golden.tif``, the JAX package's gate in
  ``tests/test_golden_raster.py``) both in memory (``predict_scene``) and
  from chip files (``create_predict_dataset`` -> ``ChipDataset`` ->
  ``predict_to_raster``, read back with the port's ``read_tiff``).
"""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cultionet_tpu import model as jax_model_api
from cultionet_tpu.data import tiny_tiff as jax_tiff
from cultionet_tpu.data.create import (
    create_predict_dataset as jax_create_predict_dataset,
)
from cultionet_tpu.data.datasets import ChipDataset as JaxDataset
from cultionet_tpu_torch.data import create as port_create
from cultionet_tpu_torch.data.constant import SCALE_FACTOR
from cultionet_tpu_torch.data.create import BatchStore, create_predict_dataset
from cultionet_tpu_torch.data.datasets import ChipDataset
from cultionet_tpu_torch.data.geotiff import read_tiff_band, write_geotiff
from cultionet_tpu_torch.data.tiny_tiff import read_tiff, write_tiff
from cultionet_tpu_torch.model import predict
from cultionet_tpu_torch.models import CultioNet
from cultionet_tpu_torch.predict import ScenePredictor
from cultionet_tpu_torch.utils.locks import file_lock
from cultionet_tpu_torch.utils.params import load_flax

from torch_port_helpers import restore_golden_checkpoint

GOLDEN = Path(__file__).parent / "data" / "golden"


@pytest.mark.parametrize(
    "num_workers, use_processes",
    [(1, "auto"), (3, False), (3, True)],
    ids=["one", "threads", "processes"],
)
def test_create_predict_dataset_matches_jax(tmp_path, num_workers, use_processes):
    scene = (
        np.random.default_rng(0).random((3, 45, 38, 2)) * 10000
    ).astype("int16")
    kwargs = dict(
        region="r1", window_size=20, padding=6, bounds=(10.0, 20.0, 48.0, 65.0)
    )
    want = jax_create_predict_dataset(
        scene, process_path=tmp_path / "jax", num_workers=1, **kwargs
    )
    got = create_predict_dataset(
        scene, process_path=tmp_path / "port", num_workers=num_workers,
        use_processes=use_processes, **kwargs,
    )
    assert [p.name for p in got] == [p.name for p in want]
    assert len(got) == 6 and all(p.parent == tmp_path / "port" for p in got)
    for port_path, jax_path in zip(got, want):
        with np.load(port_path) as a, np.load(jax_path) as b:
            assert sorted(a.files) == sorted(b.files)
            for name in b.files:
                assert a[name].dtype == b[name].dtype, name
                np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_batch_store_retries_a_corrupt_write(tmp_path, monkeypatch):
    store = BatchStore(tmp_path, window_size=8, padding=2, region="r",
                       start_date="0", end_date="1", retries=3)
    window = np.ones((2, 9, 12, 3), dtype="float32")
    calls = []
    real = port_create.Batch.from_file

    def flaky(path):
        calls.append(path)
        if len(calls) == 1:
            raise EOFError("truncated")
        return real(path)

    monkeypatch.setattr(port_create.Batch, "from_file", flaky)
    path = store.write_window(window, 8, 0, 8, 8)
    assert len(calls) == 2
    chip = real(path)
    assert chip.x.shape == (1, 2, 12, 12, 3)
    assert float(chip.x[0, :, 9:].abs().sum()) == 0.0  # zero-padded bottom
    assert chip.window_pad_bottom.tolist() == [3]
    assert chip.window_pad_right.tolist() == [0]

    def broken(path):
        raise OSError("disk")

    monkeypatch.setattr(port_create.Batch, "from_file", broken)
    with pytest.raises(IOError, match="Failed to verify"):
        store.write_window(window, 0, 0, 8, 8)
    with pytest.raises(ValueError, match="larger"):
        store.write_window(np.ones((2, 13, 12, 3), "float32"), 0, 0, 8, 8)


def test_tiff_codec_round_trips_across_packages(tmp_path):
    rng = np.random.default_rng(1)
    bands = (rng.random((3, 21, 17)) * 65535).astype("uint16")
    bounds = (500000.0, 4100000.0, 500170.0, 4100210.0)
    write_tiff(tmp_path / "port.tif", bands, bounds=bounds, crs="EPSG:32633")
    array, got_bounds, res, crs = jax_tiff.read_tiff(tmp_path / "port.tif")
    np.testing.assert_array_equal(array, bands)
    assert got_bounds == pytest.approx(bounds) and res == pytest.approx(10.0)
    assert crs == "EPSG:32633"

    band = rng.random((9, 14)).astype("float32")
    jax_tiff.write_tiff(
        tmp_path / "jax.tif", band, bounds=(-1.0, 50.0, 0.4, 50.9),
        crs="EPSG:4326",
    )
    for reader in (read_tiff, read_tiff_band):
        array, got_bounds, res, crs = reader(tmp_path / "jax.tif")
        np.testing.assert_array_equal(array, band)
        assert got_bounds == pytest.approx((-1.0, 50.0, 0.4, 50.9))
        assert res == pytest.approx(0.1) and crs == "EPSG:4326"

    write_geotiff(tmp_path / "geo.tif", bands.astype("float32"), bounds=bounds)
    array, got_bounds, _, crs = jax_tiff.read_tiff(tmp_path / "geo.tif")
    assert array.dtype == np.uint16 and crs is None
    np.testing.assert_array_equal(array, bands)
    assert got_bounds == pytest.approx(bounds)


@pytest.mark.parametrize(
    "compression, predictor",
    [("tiff_lzw", 1), ("tiff_lzw", 2), ("tiff_adobe_deflate", 1),
     ("packbits", 1)],
)
def test_tiff_codec_reads_compressed_files(tmp_path, compression, predictor):
    image = pytest.importorskip("PIL.Image")
    array = (np.random.default_rng(2).random((23, 31)) * 60000).astype("uint16")
    path = tmp_path / "c.tif"
    image.fromarray(array).save(
        path, compression=compression, tiffinfo={317: predictor}
    )
    got, *_ = read_tiff(path)
    want, *_ = jax_tiff.read_tiff(path)
    np.testing.assert_array_equal(got, array)
    np.testing.assert_array_equal(got, want)


def test_file_lock_is_exclusive(tmp_path):
    import fcntl
    import os

    target = tmp_path / "out" / "r.tif"
    with file_lock(target):
        fd = os.open(str(target) + ".lock", os.O_RDWR)
        try:
            with pytest.raises(BlockingIOError):
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        finally:
            os.close(fd)
    fd = os.open(str(target) + ".lock", os.O_RDWR)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
    finally:
        os.close(fd)


@pytest.fixture(scope="module")
def golden():
    """The trained conv checkpoint, restored by the JAX package and
    translated into the port's model; the golden raster and scene."""
    state, jax_model = restore_golden_checkpoint(GOLDEN / "ckpt" / "last_store")
    assert jax_model.temporal_encoder == "conv"
    model = CultioNet(
        in_time=jax_model.in_time,
        hidden_channels=jax_model.hidden_channels,
        dilations=jax_model.dilations,
        dropout=jax_model.dropout,
        activation_type=jax_model.activation_type,
        attention_weights=jax_model.attention_weights,
    )
    load_flax(model, {"params": state.params, "batch_stats": state.batch_stats})
    raster, *_ = jax_tiff.read_tiff(GOLDEN / "golden.tif")
    with np.load(GOLDEN / "scene.npz", allow_pickle=False) as data:
        scene = data["x"].astype(np.float32) / SCALE_FACTOR
        bounds = tuple(float(v) for v in data["bounds"])
        crs = str(data["crs"])
    return SimpleNamespace(
        state=state, model=model, raster=raster, scene=scene, bounds=bounds,
        crs=crs,
    )


def _windows(golden, root: Path, **kwargs) -> Path:
    """The golden scene's window chips (window 50, padding 10: 4 chips of
    70 x 70), as ``tests/golden_utils.py`` cuts them."""
    create_predict_dataset(
        golden.scene, region="golden", process_path=root / "processed",
        window_size=50, padding=10, num_workers=1, **kwargs,
    )
    return root


def _match(packed: np.ndarray, want: np.ndarray) -> float:
    assert packed.shape == want.shape
    return float(np.mean(packed == want))


def test_conv_golden_checkpoint_in_memory(golden):
    predictor = ScenePredictor(
        golden.model, batch_size=4, precision="fp32", device="cpu"
    )
    raster, _ = predictor.predict_scene(golden.scene, window_size=50, padding=10)
    packed = np.moveaxis(
        np.clip(raster * SCALE_FACTOR, 0, 65535).astype("uint16"), -1, 0
    )
    match = _match(packed, golden.raster)
    assert match >= 0.999, f"pixel match {match:.5f} < 0.999"


def test_conv_golden_checkpoint_from_chip_files(golden, tmp_path):
    root = _windows(golden, tmp_path, bounds=golden.bounds)
    predictor = ScenePredictor(
        golden.model, batch_size=4, precision="fp32", device="cpu"
    )
    out = predictor.predict_to_raster(
        ChipDataset(root), tmp_path / "out" / "golden.tif", crs=golden.crs
    )
    raster, bounds, res, crs = read_tiff(out)
    match = _match(raster, golden.raster)
    assert match >= 0.999, f"pixel match {match:.5f} < 0.999"
    assert crs == golden.crs
    # The chips carry the bounds as float32.
    want_bounds = tuple(float(np.float32(v)) for v in golden.bounds)
    assert bounds == pytest.approx(want_bounds, abs=1e-6)
    with np.load(out.with_suffix(".npz")) as sidecar:
        np.testing.assert_array_equal(sidecar["raster"], raster)
        assert sidecar["band_names"].tolist() == ["distance", "edge", "crop"]
        np.testing.assert_array_equal(sidecar["bounds"], want_bounds)
        left, bottom, right, top = want_bounds
        np.testing.assert_array_equal(
            sidecar["transform"],
            [(right - left) / 100, 0.0, left, 0.0, -(top - bottom) / 100, top],
        )
        assert str(sidecar["crs"]) == golden.crs
    assert res == pytest.approx((want_bounds[2] - want_bounds[0]) / 100)

    # A reference image's bounds and CRS take the chips' place.
    write_tiff(
        tmp_path / "ref.tif", np.zeros((100, 100), "uint16"),
        bounds=(0.0, 0.0, 200.0, 100.0), crs="EPSG:32610",
    )
    out = predictor.predict_to_raster(
        ChipDataset(root), tmp_path / "out" / "ref.tif",
        reference_image=tmp_path / "ref.tif",
    )
    again, bounds, res, crs = read_tiff(out)
    np.testing.assert_array_equal(again, raster)
    assert bounds == (0.0, 0.0, 200.0, 100.0) and crs == "EPSG:32610"
    assert res == 2.0


def test_model_predict_matches_jax(golden, tmp_path):
    root = _windows(golden, tmp_path)
    want = jax_model_api.predict(
        golden.state, JaxDataset(root), batch_size=3, precision="fp32"
    )
    batches = []
    got = predict(
        golden.model, ChipDataset(root), batch_size=3, precision="fp32",
        device="cpu",
    )
    assert len(got) == len(want) == 2
    for port_out, jax_out in zip(got, want):
        assert set(port_out) == {"distance", "edge", "crop"}
        for name, value in port_out.items():
            assert isinstance(value, np.ndarray) and value.dtype == np.float32
            np.testing.assert_allclose(
                value, np.asarray(jax_out[name]), atol=1e-4, rtol=0,
                err_msg=name,
            )
    assert predict(
        golden.model, ChipDataset(root), batch_size=3, device="cpu",
        writer=lambda batch, out: batches.append((batch, out)),
    ) == []
    assert [b.num_samples for b, _ in batches] == [3, 1]
    assert all(b.x.device == torch.device("cpu") for b, _ in batches)
    np.testing.assert_array_equal(batches[1][1]["crop"], got[1]["crop"])
