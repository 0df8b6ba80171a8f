"""The port's chipstore (``data/chipstore.py`` over its copy of
``native/chipstore.cpp``, built with g++) against the JAX package's on the
CPU.

- ``write_chipstore`` writes version-1 and version-2 files byte for byte as
  JAX's does from the same chips; each package reads the other's file;
  ``read_batch`` is equal field for field, and an index out of range
  raises in both.
- With one worker thread ``iter_prefetched`` gives JAX's batches in JAX's
  order over two epochs of its endless stream. The port's copy hands out
  slots in claim order (JAX's, in finish order), so ``ChipstoreLoader``
  with four threads gives every epoch of JAX's one-thread loader in order
  (and so as a multiset), and a stress run of 16 threads with batches of
  one chip gives the one-thread order.
- ``build_chipstore_from_dataset`` names the file as JAX does and rebuilds
  it when a member chip is newer; ``skip_epochs`` replays an epoch; a
  missing g++ raises, naming it.
- ``fit(use_chipstore="stream")`` with ``use_latlon`` trains (the stream
  carries each chip's lat/lon), and with ``log_transform`` raises
  ``ValueError`` (JAX asserts).
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from cultionet_tpu.config import CultionetParams as JaxParams
from cultionet_tpu.data import ChipDataset as JaxDataset
from cultionet_tpu.data.batch import Batch as JaxBatch
from cultionet_tpu.data import chipstore as jax_chipstore
from cultionet_tpu.train.fit import fit as jax_fit
from cultionet_tpu_torch.config import CultionetParams
from cultionet_tpu_torch.data import chipstore
from cultionet_tpu_torch.data.batch import Batch
from cultionet_tpu_torch.data.datasets import ChipDataset
from cultionet_tpu_torch.train.fit import fit

from torch_port_helpers import write_chip_files

FIELDS = ("x", "y", "bdist", "left", "bottom", "right", "top", "lat", "lon")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def chips(tmp_path_factory):
    """10 chips of T = 6, 12 x 12, 3 bands, x and bdist int16 x 10000."""
    root = tmp_path_factory.mktemp("chips")
    write_chip_files(root, 10, seed=21, packed=True)
    return root


@pytest.fixture(scope="module")
def float_chips(tmp_path_factory):
    root = tmp_path_factory.mktemp("float_chips")
    write_chip_files(root, 10, seed=22, packed=False)
    return root


def assert_same_batch(got: Batch, want: JaxBatch) -> None:
    for name in FIELDS:
        ours, theirs = getattr(got, name), getattr(want, name)
        assert (ours is None) == (theirs is None), name
        if ours is not None:
            theirs = np.asarray(theirs)
            assert ours.numpy().dtype == theirs.dtype, name
            np.testing.assert_array_equal(ours.numpy(), theirs, err_msg=name)


@pytest.mark.parametrize("packed", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("which", ["chips", "float_chips"])
def test_files_and_reads_match_jax(which, packed, request, tmp_path):
    root = request.getfixturevalue(which)
    files = sorted((root / "processed").glob("*.npz"))
    ours = chipstore.write_chipstore(
        tmp_path / "port.cts", [Batch.from_file(f) for f in files], packed
    )
    theirs = jax_chipstore.write_chipstore(
        tmp_path / "jax.cts", [JaxBatch.from_file(f) for f in files], packed
    )
    assert ours.read_bytes() == theirs.read_bytes()

    indices = [7, 0, 3, 3]
    # Each package reads the other's file.
    with chipstore.ChipStore(theirs) as store:
        assert (store.num_chips, store.version) == (10, 2 if packed else 1)
        assert (store.t, store.h, store.w, store.c) == (6, 12, 12, 3)
        got = store.read_batch(indices)
        with pytest.raises(IndexError):
            store.read_batch([10])
    jax_store = jax_chipstore.ChipStore(ours)
    try:
        assert_same_batch(got, jax_store.read_batch(indices))
        with pytest.raises(IndexError):
            jax_store.read_batch([10])
    finally:
        jax_store.close()
    if packed:
        assert got.x.dtype == torch.int16 and got.y.dtype == torch.int16


def _lons(batches) -> list:
    """Each batch's chips by their longitude (unique per chip here)."""
    return [np.asarray(b.lon).tolist() for b in batches]


def test_one_thread_stream_matches_jax(chips, tmp_path):
    files = sorted((chips / "processed").glob("*.npz"))
    path = chipstore.write_chipstore(
        tmp_path / "s.cts", [Batch.from_file(f) for f in files], packed=True
    )
    with chipstore.ChipStore(path) as store:
        got = [
            (b.x.clone(), _lons([b])[0])
            for b in store.iter_prefetched(
                3, seed=8, num_threads=1, num_batches=6, copy=False
            )
        ]
    jax_store = jax_chipstore.ChipStore(path)
    try:
        want = [
            (np.array(b.x), np.array(b.lon).tolist())
            for b in jax_store.iter_prefetched(
                3, seed=8, num_threads=1, num_batches=6
            )
        ]
    finally:
        jax_store.close()
    # Two epochs of 3 batches (10 chips, batches of 3): the second
    # reshuffled by the worker.
    assert [lon for _, lon in got] == [lon for _, lon in want]
    for (x, _), (x_want, _) in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), x_want)


def test_four_thread_loader_matches_the_jax_loader(chips, tmp_path):
    port = chipstore.ChipstoreLoader(
        ChipDataset(chips), batch_size=3, cache_path=tmp_path / "port" / "t.cts",
        seed=4, num_threads=4,
    )
    theirs = jax_chipstore.ChipstoreLoader(
        JaxDataset(chips), batch_size=3, cache_path=tmp_path / "jax" / "t.cts",
        seed=4, num_threads=1,
    )
    assert port.path.name == theirs.path.name
    assert len(port) == len(theirs) == 3
    for _ in range(2):
        got = _lons(port)
        want = [np.array(b.lon).tolist() for b in theirs]
        assert got == want
        assert sorted(sum(got, [])) == sorted(sum(want, []))
        assert len(set(sum(got, []))) == 9


def test_claim_order_under_many_threads(tmp_path):
    """64 one-chip batches an epoch from 16 worker threads and 16 slots,
    three times: always the one-thread order, every chip once. (Chips of
    590 KB make the copies' finish order vary: delivered in finish order,
    as the JAX package's loader does, 19 of 20 such epochs differed from
    the one-thread order.)"""
    rng = np.random.default_rng(3)
    chips = [
        Batch(
            x=torch.from_numpy(rng.random((1, 12, 64, 64, 3), dtype=np.float32)),
            left=torch.tensor([float(i)]),
        )
        for i in range(64)
    ]
    path = chipstore.write_chipstore(tmp_path / "m.cts", chips)

    def epoch(threads: int) -> list:
        with chipstore.ChipStore(path) as store:
            return [
                float(b.left[0])
                for b in store.iter_prefetched(
                    1, seed=2, num_threads=threads, max_queue=16, copy=False
                )
            ]

    want = epoch(1)
    assert sorted(want) == list(range(64))
    for _ in range(3):
        assert epoch(16) == want


def test_cache_name_and_rebuild_match_jax(chips, tmp_path):
    port_ds, jax_ds = ChipDataset(chips), JaxDataset(chips)
    port_path = chipstore.build_chipstore_from_dataset(port_ds, tmp_path / "p" / "train.cts")
    jax_path = jax_chipstore.build_chipstore_from_dataset(jax_ds, tmp_path / "j" / "train.cts")
    assert port_path.name == jax_path.name
    assert port_path.name.startswith("train-p0-") and port_path.suffix == ".cts"
    assert port_path.read_bytes() == jax_path.read_bytes()
    # Fresh stores are kept; a member chip newer than the store rebuilds.
    for path in (port_path, jax_path):
        os.utime(path, (1e9, 1e9))
    for build, ds, path in (
        (chipstore.build_chipstore_from_dataset, port_ds, port_path),
        (jax_chipstore.build_chipstore_from_dataset, jax_ds, jax_path),
    ):
        newest = max(f.stat().st_mtime for f in ds.files)
        os.utime(path, (newest, newest))
        build(ds, path.parent / "train.cts")
        assert path.stat().st_mtime == newest
        os.utime(path, (newest - 10, newest - 10))
        build(ds, path.parent / "train.cts")
        assert path.stat().st_mtime > newest - 10
    # Another membership, another store.
    other = chipstore.build_chipstore_from_dataset(
        port_ds.index_select(range(9)), tmp_path / "p" / "train.cts"
    )
    assert other != port_path


def test_skip_epochs_replays_an_epoch(chips, tmp_path):
    def loader():
        return chipstore.ChipstoreLoader(
            ChipDataset(chips), batch_size=2, cache_path=tmp_path / "t.cts",
            seed=1, num_threads=2,
        )

    whole = loader()
    epochs = [_lons(whole) for _ in range(2)]
    skipped = loader()
    skipped.skip_epochs(1)
    assert _lons(skipped) == epochs[1]
    assert epochs[0] != epochs[1]


def test_rank_blocks_split_every_batch(chips, tmp_path):
    """``shard=(rank, 2)``: from the one store, each rank's loader yields
    its contiguous half of every batch the whole loader yields, two epochs
    running; a batch the ranks do not divide is refused."""

    def loader(shard=None):
        return chipstore.ChipstoreLoader(
            ChipDataset(chips), batch_size=4, cache_path=tmp_path / "t.cts",
            seed=5, num_threads=3, shard=shard,
        )

    whole = loader()
    halves = [loader((rank, 2)) for rank in range(2)]
    assert [h.path for h in halves] == [whole.path] * 2
    assert [len(h) for h in halves] == [len(whole)] * 2 == [2] * 2
    for _ in range(2):
        want = list(whole)
        got = [list(h) for h in halves]
        for i, batch in enumerate(want):
            for rank in range(2):
                block = got[rank][i]
                assert block.num_samples == 2
                for name in FIELDS:
                    np.testing.assert_array_equal(
                        getattr(block, name).numpy(),
                        getattr(batch, name)[2 * rank : 2 * rank + 2].numpy(),
                        err_msg=name,
                    )
    with pytest.raises(ValueError, match="does not split over 3 ranks"):
        loader((0, 3))


def test_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(chipstore, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(chipstore.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        chipstore.build_library()


CONFIG = dict(
    val_frac=0.2,
    batch_size=2,
    epochs=1,
    hidden_channels=4,
    dilations=[1],
    attention_weights=None,
    dropout=0.0,
    precision="32",
    in_channels=3,
    in_time=6,
)


def test_stream_fit_with_latlon(chips, tmp_path):
    params = CultionetParams(
        ckpt_file=tmp_path / "ckpt" / "last.ckpt",
        dataset=ChipDataset(chips),
        use_chipstore="stream",
        use_latlon=True,
        device_augment=True,
        **CONFIG,
    )
    result = fit(params, device="cpu")
    assert result.state.step == 4
    for key in ("loss", "val_loss", "val_score"):
        assert np.isfinite(result.history[0][key]), key
    stores = list((tmp_path / "ckpt").glob("train-p0-*.cts"))
    assert len(stores) == 1
    with chipstore.ChipStore(stores[0]) as store:
        assert store.packed and store.num_chips == 8


def test_log_transform_refused(chips, tmp_path):
    with pytest.raises(ValueError, match="log_transform"):
        fit(
            CultionetParams(
                dataset=ChipDataset(chips, log_transform=True),
                use_chipstore="stream",
                **CONFIG,
            ),
            device="cpu",
        )
    with pytest.raises(AssertionError, match="log_transform"):
        jax_fit(
            JaxParams(
                dataset=JaxDataset(chips, log_transform=True),
                use_chipstore="stream",
                **CONFIG,
            )
        )
    assert not list(Path(chips).glob("cache/*.cts"))
