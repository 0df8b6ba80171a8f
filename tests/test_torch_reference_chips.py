"""Reference-framework joblib ``.pt`` chips in the port
(``data/batch.py::Batch.from_reference_file``) against the JAX package's
reader on the CPU.

- The dict chip of ``tests/test_dataset.py`` ((B, C, T, H, W) x) and a
  v1-era node-format chip (a pickled torch_geometric ``Data``, written here
  with stand-in classes and read through each package's import shim) read
  field for field as JAX reads them, values and types, ``read_meta`` too;
  in a fresh process the port's own shim reads the v1 chip.
- ``ChipDataset`` lists ``.pt`` chips beside ``.npz`` ones and scales them
  as JAX's does; the chipstore file and the resident split built from
  ``.pt`` chips equal JAX's.
- Without joblib the reader raises ``ImportError`` naming it.
"""

import dataclasses
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from cultionet_tpu.data import ChipDataset as JaxDataset
from cultionet_tpu.data import chipstore as jax_chipstore
from cultionet_tpu.data.batch import Batch as JaxBatch
from cultionet_tpu.data.device_cache import DeviceChipCache as JaxCache
from cultionet_tpu_torch.data import chipstore
from cultionet_tpu_torch.data.batch import Batch
from cultionet_tpu_torch.data.constant import SCALE_FACTOR
from cultionet_tpu_torch.data.datasets import ChipDataset
from cultionet_tpu_torch.data.device_cache import DeviceChipCache

joblib = pytest.importorskip("joblib")

FIELDS = [f.name for f in dataclasses.fields(Batch) if f.name != "batch_id"]


def assert_same(got: Batch, want: JaxBatch, fields=FIELDS) -> None:
    assert got.batch_id == want.batch_id
    for name in fields:
        ours, theirs = getattr(got, name), getattr(want, name)
        assert (ours is None) == (theirs is None), name
        if ours is not None:
            theirs = np.asarray(theirs)
            assert ours.numpy().dtype == theirs.dtype, (name, ours.dtype)
            np.testing.assert_array_equal(ours.numpy(), theirs, err_msg=name)


def dict_chip(rng, window: bool = False) -> dict:
    """The reference's dict chip layout (as ``tests/test_dataset.py``
    writes it), optionally with prediction-window geometry."""
    stored = {
        "x": (rng.random((1, 3, 12, 10, 10)) * SCALE_FACTOR).astype("int16"),
        "y": rng.integers(-1, 3, size=(1, 10, 10)),
        "bdist": (rng.random((1, 10, 10)) * SCALE_FACTOR).astype("int16"),
        "left": np.array([10.0]),
        "bottom": np.array([40.0]),
        "right": np.array([10.1]),
        "top": np.array([40.1]),
    }
    if window:
        stored.update(
            window_row_off=np.array([20]), window_col_off=np.array([40]),
            window_height=np.array([10]), window_width=np.array([10]),
            window_pad_bottom=np.array([0]), window_pad_right=np.array([2]),
            batch_id=["chip_a"],
        )
    return stored


def write_pyg_chip(path, rng) -> None:
    """A v1-era chip: a torch_geometric ``Data`` whose storage holds x
    (H * W, C * T) in band-major columns and flat y and bdist. Stand-in
    classes carry torch_geometric's module paths while the file is
    written, then leave ``sys.modules``, so that reading goes through the
    import shim."""
    height, width, ntime, nbands = 6, 5, 4, 2
    names = ["torch_geometric", "torch_geometric.data",
             "torch_geometric.data.data", "torch_geometric.data.storage"]
    saved = {name: sys.modules.get(name) for name in names}
    modules = {name: types.ModuleType(name) for name in names}

    class Data:
        pass

    class GlobalStorage:
        pass

    Data.__module__, Data.__qualname__ = "torch_geometric.data.data", "Data"
    GlobalStorage.__module__ = "torch_geometric.data.storage"
    GlobalStorage.__qualname__ = "GlobalStorage"
    modules["torch_geometric.data.data"].Data = Data
    modules["torch_geometric.data.storage"].GlobalStorage = GlobalStorage
    store = GlobalStorage()
    store._mapping = {
        "x": torch.from_numpy(
            rng.random((height * width, nbands * ntime), dtype=np.float32)
        ),
        "y": torch.from_numpy(rng.integers(-1, 3, height * width)),
        "bdist": torch.from_numpy(rng.random(height * width)),
        "height": height, "width": width, "ntime": ntime, "nbands": nbands,
        "left": 1.5, "bottom": 2.0, "right": 1.75, "top": 2.5,
    }
    data = Data()
    data._store = store
    try:
        sys.modules.update(modules)
        joblib.dump(data, path)
    finally:
        for name, module in saved.items():
            if module is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = module


@pytest.fixture(scope="module")
def pt_chips(tmp_path_factory):
    """Three dict chips (one with window geometry) and one v1 chip."""
    root = tmp_path_factory.mktemp("pt_chips")
    processed = root / "processed"
    processed.mkdir()
    rng = np.random.default_rng(1)
    for i in range(3):
        joblib.dump(dict_chip(rng, window=i == 2), processed / f"data_{i:06d}_2022_none.pt")
    write_pyg_chip(root / "v1_chip.pt", rng)
    return root


@pytest.mark.parametrize(
    "name", ["processed/data_000000_2022_none.pt",
             "processed/data_000002_2022_none.pt", "v1_chip.pt"]
)
def test_reader_matches_jax(pt_chips, name):
    path = pt_chips / name
    got, want = Batch.from_file(path), JaxBatch.from_file(path)
    assert_same(got, want)
    meta, jax_meta = Batch.read_meta(path), JaxBatch.read_meta(path)
    assert meta.x.shape == jax_meta.x.shape == (1, 0)  # placeholders
    assert_same(meta, jax_meta, [f for f in FIELDS if f != "x"])
    if name == "v1_chip.pt":
        assert got.x.shape == (1, 4, 6, 5, 2) and got.y.dtype == torch.int32
    else:
        assert got.x.shape == (1, 12, 10, 10, 3) and got.x.dtype == torch.int16


def test_dataset_reads_pt_chips_as_jax(pt_chips, tmp_path):
    dataset, jax_dataset = ChipDataset(pt_chips), JaxDataset(pt_chips)
    assert dataset.files == jax_dataset.files and len(dataset) == 3
    for i in range(3):
        got, want = dataset[i], jax_dataset[i]
        for name in ("x", "bdist", "lat", "lon"):
            np.testing.assert_array_equal(
                getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                err_msg=name,
            )
    assert float(dataset[0].lon[0]) == pytest.approx(10.05)

    ours = chipstore.build_chipstore_from_dataset(dataset, tmp_path / "p" / "t.cts")
    theirs = jax_chipstore.build_chipstore_from_dataset(
        jax_dataset, tmp_path / "j" / "t.cts"
    )
    assert ours.name == theirs.name and ours.read_bytes() == theirs.read_bytes()
    cache = DeviceChipCache(dataset, batch_size=2, device="cpu")
    jax_cache = JaxCache(jax_dataset, batch_size=2)
    for name in ("x", "y", "bdist"):
        np.testing.assert_array_equal(
            cache.arrays[name].numpy(), np.asarray(jax_cache.arrays[name])
        )


def test_v1_chip_through_the_ports_own_shim(pt_chips, tmp_path):
    """In a fresh process (where no shim of the JAX package is installed)
    the port's shim alone unpickles the v1 chip."""
    out = tmp_path / "v1.npz"
    code = (
        "import sys; from cultionet_tpu_torch.data.batch import Batch; "
        f"b = Batch.from_file({str(pt_chips / 'v1_chip.pt')!r}); "
        f"b.to_file({str(out)!r}, compression='none'); "
        "assert 'cultionet_tpu' not in sys.modules"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=Path(__file__).resolve().parents[1],
    )
    assert proc.returncode == 0, proc.stderr
    assert_same(Batch.from_file(out), JaxBatch.from_file(pt_chips / "v1_chip.pt"))


def test_missing_joblib_raises(pt_chips, monkeypatch):
    monkeypatch.setitem(sys.modules, "joblib", None)
    with pytest.raises(ImportError, match="joblib"):
        Batch.from_file(pt_chips / "v1_chip.pt")
