"""The port's data pipeline (``cultionet_tpu_torch/data/``,
``utils/normalize.py``, ``utils/stats.py``) against the JAX package on the
same chip files: ``.npz`` chips read identically across the packages,
``ChipDataset`` values and splits, ``ChipLoader`` batch order,
``NormValues``. Values to 1e-6, absolute and relative (numpy against XLA
fp32 arithmetic: one ulp of the log-transformed, normalized values);
files, orders, splits and counts exactly."""

from pathlib import Path

import numpy as np
import pytest
import torch

from cultionet_tpu.data import ChipDataset as JaxDataset
from cultionet_tpu.data import create_batch as jax_create_batch
from cultionet_tpu.data.batch import Batch as JaxBatch
from cultionet_tpu.data.loader import ChipLoader as JaxLoader
from cultionet_tpu.data.samplers import EpochRandomSampler as JaxSampler
from cultionet_tpu.utils.normalize import NormValues as JaxNormValues
from cultionet_tpu_torch.data.batch import Batch, collate
from cultionet_tpu_torch.data.datasets import ChipDataset
from cultionet_tpu_torch.data.loader import ChipLoader
from cultionet_tpu_torch.data.samplers import EpochRandomSampler
from cultionet_tpu_torch.data.synthetic import create_batch
from cultionet_tpu_torch.utils.normalize import NormValues

FIELDS = (
    "x", "y", "bdist", "lat", "lon", "left", "bottom", "right", "top",
)


def write_chips(
    root: Path, num: int = 10, seed: int = 100, packed=False, size=16
):
    """``num`` seeded chips written by the JAX package (int16-packed x and
    bdist when ``packed``, as the chip creator writes them)."""
    rng = np.random.default_rng(seed)
    for _ in range(num):
        batch = jax_create_batch(
            num_channels=3, num_time=4, height=size, width=size, rng=rng
        )
        if packed:
            batch = batch.replace(
                x=np.asarray(batch.x * 10000).astype("int16"),
                bdist=np.asarray(batch.bdist * 10000).astype("int16"),
            )
        batch.to_file(root / "processed" / batch.batch_id[0])
    return root


def assert_batches_equal(port: Batch, jax_batch, atol=0.0):
    for name in FIELDS:
        want = getattr(jax_batch, name)
        got = getattr(port, name)
        assert (got is None) == (want is None), name
        if want is None:
            continue
        want = np.asarray(want)
        got = got.numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_allclose(got, want, atol=atol, rtol=atol, err_msg=name)
    assert port.batch_id == jax_batch.batch_id


def test_chips_read_identically_across_packages(tmp_path):
    rng = np.random.default_rng(0)
    jax_batch = jax_create_batch(num_time=4, height=8, width=8, rng=rng)
    jax_batch.to_file(tmp_path / "jax.npz")
    assert_batches_equal(Batch.from_file(tmp_path / "jax.npz"), jax_batch)

    port = create_batch(
        num_time=4, height=8, width=8, batch_size=2,
        rng=np.random.default_rng(0),
    )
    port.to_file(tmp_path / "port.npz", compression="none")
    back = JaxBatch.from_file(tmp_path / "port.npz")
    assert_batches_equal(port, back)
    assert_batches_equal(Batch.from_file(tmp_path / "port.npz"), back)
    meta = Batch.read_meta(tmp_path / "port.npz")
    assert meta.batch_id == port.batch_id
    assert torch.equal(meta.left, port.left) and meta.x.shape == (2, 0)
    # Reference joblib .pt chips read as JAX reads them
    # (tests/test_torch_reference_chips.py holds the reader field by field).
    joblib = pytest.importorskip("joblib")
    joblib.dump({"x": np.ones((1, 2, 3, 4, 4), "int16")}, tmp_path / "chip.pt")
    chip = Batch.from_file(tmp_path / "chip.pt")
    assert chip.x.shape == (1, 3, 4, 4, 2) and chip.batch_id == ("chip.pt",)
    assert_batches_equal(chip, JaxBatch.from_file(tmp_path / "chip.pt"))


def test_synthetic_batch_matches_jax():
    got = create_batch(num_time=3, height=6, width=5, batch_size=2)
    want = jax_create_batch(num_time=3, height=6, width=5, batch_size=2)
    assert_batches_equal(got, want)


def test_collate_and_properties():
    a = create_batch(num_time=3, height=6, width=5, batch_size=2)
    b = create_batch(
        num_time=3, height=6, width=5, rng=np.random.default_rng(1)
    )
    both = collate([a, b])
    assert both.num_samples == 3 and both.num_time == 3
    assert (both.height, both.width, both.num_channels) == (6, 5, 3)
    assert both.batch_id == a.batch_id + b.batch_id
    assert torch.equal(both.x[2:], b.x) and torch.equal(both.lat[:2], a.lat)
    assert not both.is_packed
    packed = both.replace(x=(both.x * 10000).to(torch.int16))
    assert packed.is_packed
    assert packed.dequantize().x.dtype == torch.float32


@pytest.mark.parametrize(
    "packed,log_transform,normalized",
    [(False, False, False), (True, False, True), (True, True, True)],
)
def test_dataset_values_match_jax(tmp_path, packed, log_transform, normalized):
    root = write_chips(tmp_path, num=4, packed=packed)
    jax_norm = norm = None
    if normalized:
        arrays = dict(
            dataset_mean=np.asarray([0.4, 0.5, 0.6], "float32"),
            dataset_std=np.asarray([0.2, 0.3, 0.25], "float32"),
            dataset_crop_counts=np.asarray([100, 50]),
            dataset_edge_counts=np.asarray([140, 10]),
            num_channels=3,
        )
        jax_norm, norm = JaxNormValues(**arrays), NormValues(**arrays)
    jax_ds = JaxDataset(root, norm_values=jax_norm, log_transform=log_transform)
    ds = ChipDataset(
        root, norm_values=norm, log_transform=log_transform, preload=True
    )
    assert ds.files == jax_ds.files and len(ds) == 4
    for i in range(len(ds)):
        assert_batches_equal(ds[i], jax_ds[i], atol=1e-6)
    assert_batches_equal(ds[0], jax_ds[0], atol=1e-6)  # from the cache
    np.testing.assert_allclose(ds.centroids(), jax_ds.centroids())


@pytest.mark.parametrize("spatial", [False, True])
def test_split_and_loader_order_match_jax(tmp_path, spatial):
    root = write_chips(tmp_path, num=11)
    jax_train, jax_val = JaxDataset(root).split_train_val(
        0.2, spatial_balance=spatial
    )
    train, val = ChipDataset(root).split_train_val(
        0.2, spatial_balance=spatial
    )
    assert train.files == jax_train.files and val.files == jax_val.files
    assert val.augment_prob == 0.0
    jax_loader = JaxLoader(jax_train, batch_size=3, shuffle=True, drop_last=True)
    loader = ChipLoader(train, batch_size=3, shuffle=True, drop_last=True)
    assert len(loader) == len(jax_loader) == 3
    for _ in range(2):  # two epochs: two permutations
        want = [b.batch_id for b in jax_loader]
        got = [b.batch_id for b in loader]
        assert got == want
    # A resumed loader that skips two epochs continues in step.
    skipped = ChipLoader(train, batch_size=3, shuffle=True, drop_last=True)
    skipped.skip_epochs(2)
    assert [b.batch_id for b in skipped] == [b.batch_id for b in jax_loader]
    tail = ChipLoader(val, batch_size=2)
    assert [b.num_samples for b in tail] == [2]
    assert train.index_select([2, 0]).files == [train.files[2], train.files[0]]


def test_kfold_and_sampler_match_jax(tmp_path):
    root = write_chips(tmp_path, num=9)
    want = [
        (name, t.files, v.files)
        for name, t, v in JaxDataset(root).spatial_kfoldcv_iter(
            3, rng=np.random.default_rng(5)
        )
    ]
    got = [
        (name, t.files, v.files)
        for name, t, v in ChipDataset(root).spatial_kfoldcv_iter(
            3, rng=np.random.default_rng(5)
        )
    ]
    assert got == want
    jax_sampler, sampler = JaxSampler(20, 7, seed=3), EpochRandomSampler(20, 7, seed=3)
    for _ in range(2):
        assert list(sampler) == list(jax_sampler)


def test_loader_raises_the_dataset_error(tmp_path):
    """The loader yields augmented batches from its thread (every chip
    augmented at augment_prob 1 with fliplr: equal to the flipped chips),
    and an error the dataset raises there reaches the caller."""
    root = write_chips(tmp_path, num=3)
    plain = list(ChipLoader(ChipDataset(root), batch_size=2))
    ds = ChipDataset(root, augment_prob=1.0, augmentations=["fliplr"])
    flipped = list(ChipLoader(ds, batch_size=2))
    assert [b.num_samples for b in flipped] == [2, 1]
    for got, want in zip(flipped, plain):
        assert torch.equal(got.x, want.x.flip(3))
        assert torch.equal(got.y, want.y.flip(2))
        assert torch.equal(got.bdist, want.bdist.flip(2))
    ds.files.append(tmp_path / "processed" / "missing.npz")
    with pytest.raises(FileNotFoundError, match="missing"):
        list(ChipLoader(ds, batch_size=2))


def test_preload_cache_survives_augmented_epochs(tmp_path):
    """Two epochs of augmented loading under ``preload`` leave the cached
    chips as they were read, and later chips come from the cache."""
    # 20 x 20: Perlin noise needs sides divisible by 10.
    root = write_chips(tmp_path, num=6, packed=True, size=20)
    ds = ChipDataset(root, augment_prob=1.0, preload=True, random_seed=2)
    for _ in range(2):
        for batch in ChipLoader(ds, batch_size=2, shuffle=True):
            assert batch.num_samples == 2
    assert set(ds._cache) == set(ds.files)
    # What load_file hands out is a copy: writing to it leaves the cache.
    for name, value in ds.load_file(ds.files[0]).tensors().items():
        value.zero_()
    for path, cached in ds._cache.items():
        fresh = Batch.from_file(path)
        for name, value in fresh.tensors().items():
            assert torch.equal(cached.tensors()[name], value), (path, name)
        assert cached.x.dtype == torch.int16


def test_norm_values_match_jax(tmp_path):
    root = write_chips(tmp_path, num=6, packed=True)
    info = {"max_crop_class": 1, "edge_class": 2}
    want = JaxNormValues.from_dataset(JaxDataset(root), info)
    got = NormValues.from_dataset(ChipDataset(root), info)
    for name in ("dataset_mean", "dataset_std", "lower_bound", "upper_bound"):
        np.testing.assert_allclose(
            getattr(got, name), getattr(want, name), atol=1e-6, err_msg=name
        )
    np.testing.assert_array_equal(got.dataset_crop_counts, want.dataset_crop_counts)
    np.testing.assert_array_equal(got.dataset_edge_counts, want.dataset_edge_counts)

    # Each package reads the other's file.
    got.to_file(tmp_path / "port.norm.npz")
    back = JaxNormValues.from_file(tmp_path / "port.norm.npz")
    np.testing.assert_array_equal(back.dataset_std, got.dataset_std)
    want.to_file(tmp_path / "jax.norm.npz")
    read = NormValues.from_file(tmp_path / "jax.norm.npz")
    np.testing.assert_array_equal(read.dataset_mean, want.dataset_mean)

    # A cached pass restores the statistics without reading a chip.
    cache = tmp_path / "stats"
    first = NormValues.from_dataset(ChipDataset(root), info, cache_dir=cache)
    again = NormValues.from_dataset([], info, cache_dir=cache)
    np.testing.assert_array_equal(again.dataset_mean, first.dataset_mean)
    np.testing.assert_array_equal(again.dataset_std, first.dataset_std)


def test_check_dims_names_and_deletes_mismatches(tmp_path):
    from cultionet_tpu_torch.errors import TensorShapeError

    root = write_chips(tmp_path, num=3)
    odd = create_batch(num_time=5, height=16, width=16)
    odd.to_file(root / "processed" / "data_odd.npz")
    ds = ChipDataset(root)
    with pytest.raises(TensorShapeError, match="data_odd"):
        ds.check_dims(expected_time=4, expected_channels=3)
    assert ds.check_dims(expected_time=5, delete_mismatches=True) != []
    assert [p.name for p in ds.files] == ["data_odd.npz"]
    ds.shuffle()
    assert len(ds) == 1
