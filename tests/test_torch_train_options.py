"""The port's training options off the CLI default, held to the JAX package
on the same weights and chips on the CPU (fp32, dropout 0):

- ``train/lr_finder.py``: ``fit(auto_lr_find=True)`` sweeps the same
  learning rates as JAX's (exactly) with smoothed losses within 1e-4 up to
  JAX's stop step; ``suggest_lr`` equals JAX's on the same curve.
- ``train/prune.py``: ``l1_unstructured_prune`` and ``sparsity`` equal
  JAX's exactly, ties at the threshold included, on arrays and on the
  tiny model's parameters; ``fit(model_pruning=True)`` returns a pruned
  state.
- RAdam (``train/optim.py::OptaxRAdam``) against the optax chain of
  ``cultionet_tpu/train/optim.py`` over 20 updates within 1e-6, across the
  rectification threshold (rho >= 5 from the 6th update at b2 = 0.99).
- ``data/vector.py::read_feature_table`` and the partition split and
  folds (``data/datasets.py``) equal to JAX's on the same GeoJSON and
  GeoPackage; ``fit`` validates on the named partition.

Transfer learning (``model.fit_transfer``) is held to JAX in
``test_torch_transfer.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cultionet_tpu.config import CultionetParams as JaxParams
from cultionet_tpu.data import ChipDataset as JaxDataset
from cultionet_tpu.data import create_batch as jax_create_batch
from cultionet_tpu.data.batch import Batch as JaxBatch
from cultionet_tpu.data.vector import read_feature_table as jax_read_table
from cultionet_tpu.models import CultioNet as JaxCultioNet
from cultionet_tpu.train import lr_finder as jax_lr_finder
from cultionet_tpu.train import prune as jax_prune
from cultionet_tpu.train import step as jax_step
from cultionet_tpu.train.fit import fit as jax_fit
from cultionet_tpu.train.optim import build_optimizer as jax_build_optimizer
from cultionet_tpu_torch.config import CultionetParams
from cultionet_tpu_torch.data.datasets import ChipDataset
from cultionet_tpu_torch.data.vector import read_feature_table
from cultionet_tpu_torch.models import CultioNet
from cultionet_tpu_torch.train import lr_finder
from cultionet_tpu_torch.train.fit import fit
from cultionet_tpu_torch.train.optim import build_optimizer
from cultionet_tpu_torch.train.prune import l1_unstructured_prune, sparsity
from cultionet_tpu_torch.utils.params import from_flax, load_flax

from test_torch_create_train import write_gpkg
from torch_port_helpers import seeded_variables

MODEL = dict(hidden_channels=4, dilations=[1], attention_weights=None)
CONFIG = dict(
    val_frac=0.2, batch_size=2, epochs=2, learning_rate=1e-3,
    loss_name="TanimotoComplementLoss", precision="32", dropout=0.0,
    in_channels=3, in_time=6, **MODEL,
)
WEST = [[-180.0, -90.0], [0.0, -90.0], [0.0, 90.0], [-180.0, 90.0],
        [-180.0, -90.0]]
EAST = [[0.0, -90.0], [180.0, -90.0], [180.0, 90.0], [0.0, 90.0],
        [0.0, -90.0]]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def chips(tmp_path_factory):
    """10 chips of 16 x 16, T = 6, their centroids spread over the globe."""
    root = tmp_path_factory.mktemp("chips")
    rng = np.random.default_rng(100)
    for _ in range(10):
        batch = jax_create_batch(
            num_channels=3, num_time=6, height=16, width=16, rng=rng
        )
        batch.to_file(root / "processed" / batch.batch_id[0])
    return root


@pytest.fixture(scope="module")
def variables():
    return seeded_variables(
        JaxCultioNet(in_time=6, dropout=0.0, **MODEL),
        JaxBatch(x=jnp.zeros((1, 6, 16, 16, 3))), training=False, seed=3,
    )


@pytest.fixture(scope="module")
def partition_files(tmp_path_factory):
    """The same two named partitions (west, east; a third, "empty", holds
    no chip) as GeoJSON and as a GeoPackage."""
    import json

    root = tmp_path_factory.mktemp("partitions")
    features = [
        {"type": "Feature", "properties": {"name": name, "zone": i},
         "geometry": {"type": "Polygon", "coordinates": [ring]}}
        for i, (name, ring) in enumerate(
            [("west", WEST), ("east", EAST),
             ("empty", [[500, 500], [501, 500], [501, 501], [500, 500]])]
        )
    ]
    geojson = root / "parts.geojson"
    geojson.write_text(
        json.dumps({"type": "FeatureCollection", "features": features})
    )
    gpkg = root / "parts.gpkg"
    write_gpkg(
        gpkg, [([[WEST]], "west"), ([[EAST]], "east")], class_column="name"
    )
    return {"geojson": geojson, "gpkg": gpkg}


def _patch_init(monkeypatch, variables):
    """Both sweeps start from ``variables``: JAX's ``create_train_state``
    and the port's as ``lr_finder`` calls them."""

    def jax_state(model, tx, init_batch, seed=0):
        return jax_step.TrainState.create(
            apply_fn=model.apply, params=variables["params"],
            batch_stats=variables["batch_stats"], tx=tx,
        )

    real = lr_finder.create_train_state

    def port_state(model, tx, seed=None, device="cuda"):
        load_flax(model, variables)
        return real(model, tx, device=device)

    monkeypatch.setattr(jax_lr_finder, "create_train_state", jax_state)
    monkeypatch.setattr(lr_finder, "create_train_state", port_state)


def test_lr_find_matches_jax(chips, variables, monkeypatch, tmp_path):
    _patch_init(monkeypatch, variables)
    config = {**CONFIG, "auto_lr_find": True}
    want = jax_fit(JaxParams(dataset=JaxDataset(chips), **config))
    got = fit(CultionetParams(dataset=ChipDataset(chips), **config),
              device="cpu")
    assert got.state is None and want.state is None
    jax_lrs = [row["lr"] for row in want.history]
    lrs = [row["lr"] for row in got.history]
    assert 8 <= len(jax_lrs) <= 100
    assert lrs[: len(jax_lrs)] == jax_lrs
    assert all(a < b for a, b in zip(lrs, lrs[1:]))
    np.testing.assert_allclose(
        [row["loss"] for row in got.history][: len(jax_lrs)],
        [row["loss"] for row in want.history], atol=1e-4, rtol=0,
    )
    assert len(lrs) == len(jax_lrs)
    assert got.best_score == want.best_score == lr_finder.suggest_lr(
        lrs, [row["loss"] for row in got.history]
    )


def test_suggest_lr_matches_jax():
    rng = np.random.default_rng(0)
    for n in (7, 8, 30):
        lrs = list(np.geomspace(1e-7, 1.0, n))
        curve = list(np.cumsum(rng.normal(size=n)))
        assert lr_finder.suggest_lr(lrs, curve) == jax_lr_finder.suggest_lr(
            lrs, curve
        )
    assert lr_finder.suggest_lr([1.0] * 7, [1.0] * 7) is None


def test_prune_matches_jax(variables):
    """Integer-valued arrays (ties at the threshold), a 1-D and a small
    tensor (kept), then the tiny model's parameters in the port's layout:
    equal to JAX's pruning bit for bit, and the same sparsity."""
    rng = np.random.default_rng(1)
    arrays = {
        "ties": (rng.integers(1, 4, size=(8, 6))
                 * rng.choice([-1, 1], size=(8, 6))).astype("float32"),
        "conv": rng.normal(size=(3, 3, 4, 5)).astype("float32"),
        "bias": rng.normal(size=(64,)).astype("float32"),
        "small": rng.normal(size=(4, 7)).astype("float32"),
    }
    want = jax_prune.l1_unstructured_prune(
        {k: jnp.asarray(v) for k, v in arrays.items()}
    )
    got = l1_unstructured_prune({k: torch.from_numpy(v) for k, v in arrays.items()})
    for name in arrays:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
    assert int((got["ties"] == 0).sum()) > int(0.2 * 48)  # the ties went
    assert torch.equal(got["bias"], torch.from_numpy(arrays["bias"]))
    assert sparsity(got) == jax_prune.sparsity(want)

    params = {"params": jax.tree_util.tree_map(jnp.asarray, variables["params"])}
    want = from_flax(
        {"params": jax_prune.l1_unstructured_prune(params["params"])}
    )
    model = load_flax(CultioNet(in_time=6, dropout=0.0, **MODEL), variables)
    got = l1_unstructured_prune(dict(model.named_parameters()))
    assert set(got) == set(want)
    for name, value in want.items():
        assert torch.equal(got[name], value), name
    assert sparsity(got) == jax_prune.sparsity(
        jax_prune.l1_unstructured_prune(params["params"])
    )


def test_fit_model_pruning(chips, tmp_path):
    """One epoch with ``model_pruning``: every parameter of 2 or more
    dimensions and 32 or more entries holds at least int(0.2 n) zeros after
    the epochs; the saved ``last`` checkpoint is the unpruned epoch's, as
    in the JAX loop."""
    from cultionet_tpu_torch.model import load_model

    params = CultionetParams(
        ckpt_file=tmp_path / "last.ckpt", dataset=ChipDataset(chips),
        **{**CONFIG, "epochs": 1, "model_pruning": True},
    )
    got = fit(params, device="cpu")
    pruned = dict(got.state.model.named_parameters())
    checked = 0
    for value in pruned.values():
        if value.dim() >= 2 and value.numel() >= 32:
            assert int((value == 0).sum()) >= int(0.2 * value.numel())
            checked += 1
    assert checked > 10 and sparsity(pruned) > 0.15
    _, saved = load_model(tmp_path / "last_store", "last", device="cpu")
    assert sparsity(dict(saved.named_parameters())) < 0.01


def _radam_problem():
    rng = np.random.default_rng(2)
    params = {
        "w": rng.normal(size=(5, 4)).astype("float32"),
        "b": rng.normal(size=(4,)).astype("float32"),
    }
    grads = [
        {k: rng.normal(size=v.shape).astype("float32") * 0.5
         for k, v in params.items()}
        for _ in range(20)
    ]
    return params, grads


@pytest.mark.parametrize("clip", [None, 1.0])
def test_radam_matches_optax(clip):
    params, grads = _radam_problem()
    kwargs = dict(learning_rate=1e-2, weight_decay=1e-2, eps=1e-4,
                  gradient_clip_val=clip)
    tx = jax_build_optimizer("RAdam", **kwargs)
    jax_params = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jax_params)
    tensors = {k: torch.tensor(v) for k, v in params.items()}
    optimizer = build_optimizer("RAdam", **kwargs).init(tensors.values())
    for step, g in enumerate(grads):
        updates, opt_state = tx.update(
            {k: jnp.asarray(v) for k, v in g.items()}, opt_state, jax_params
        )
        jax_params = optax.apply_updates(jax_params, updates)
        for name, tensor in tensors.items():
            tensor.grad = torch.tensor(g[name])
        assert optimizer.step()
        for name, tensor in tensors.items():
            np.testing.assert_allclose(
                tensor.numpy(), np.asarray(jax_params[name]), atol=1e-6,
                rtol=0, err_msg=f"{name} after update {step + 1}",
            )


@pytest.mark.parametrize("kind", ["geojson", "gpkg"])
def test_read_feature_table_matches_jax(partition_files, kind):
    got = read_feature_table(partition_files[kind])
    want = jax_read_table(partition_files[kind])
    assert len(got) == len(want) >= 2
    for (ring, props), (jax_ring, jax_props) in zip(got, want):
        np.testing.assert_array_equal(ring, jax_ring)
        assert props == jax_props


@pytest.mark.parametrize("kind", ["geojson", "gpkg"])
def test_partition_split_and_folds_match_jax(chips, partition_files, kind):
    path = partition_files[kind]
    names = lambda ds: [p.name for p in ds.files]  # noqa: E731
    for name in ("west", "east"):
        got = ChipDataset(chips).split_by_partition(path, name)
        want = JaxDataset(chips).split_by_partition(path, name)
        assert [names(d) for d in got] == [names(d) for d in want]
        assert names(got[1]) and names(got[0])
    with pytest.raises(ValueError, match="no chips"):
        ChipDataset(chips).split_by_partition(path, "nowhere")
    missing = path.with_name("missing.gpkg")
    with pytest.raises(FileNotFoundError, match="missing.gpkg"):
        ChipDataset(chips).split_by_partition(missing, "west")
    assert not missing.exists()
    got = list(ChipDataset(chips).partition_kfoldcv_iter(path))
    want = list(JaxDataset(chips).partition_kfoldcv_iter(path))
    assert [f[0] for f in got] == [f[0] for f in want] == ["west", "east"]
    for g, w in zip(got, want):
        assert names(g[1]) == names(w[1]) and names(g[2]) == names(w[2])


def test_fit_validates_on_the_named_partition(chips, partition_files, tmp_path):
    """``fit`` with a partition file and name validates on the partition's
    chips: the per-batch validation metrics count its chips; one epoch at
    hidden 4."""
    path = partition_files["geojson"]
    _, val_ds = ChipDataset(chips).split_by_partition(path, "east")
    params = CultionetParams(
        ckpt_file=tmp_path / "last.ckpt", dataset=ChipDataset(chips),
        spatial_partitions=str(path), partition_name="east",
        save_batch_val_metrics=True, **{**CONFIG, "epochs": 1},
    )
    got = fit(params, device="cpu")
    assert np.isfinite(got.history[0]["val_score"])
    parquet = tmp_path / "batch_metrics.parquet"
    if parquet.exists():
        import pandas as pd

        counts = pd.read_parquet(parquet)["num_samples"].tolist()
    else:
        import csv

        with open(tmp_path / "batch_metrics.csv") as fh:
            counts = [int(r["num_samples"]) for r in csv.DictReader(fh)]
    assert 0 < sum(counts) == len(val_ds) < 10


def test_fit_refuses_a_missing_partition_file(chips, tmp_path):
    """A partition file that does not exist raises, naming the file, where
    the JAX loop falls back to a spatial split (a deliberate difference)."""
    missing = tmp_path / "nowhere.geojson"
    params = CultionetParams(
        ckpt_file=tmp_path / "last.ckpt", dataset=ChipDataset(chips),
        spatial_partitions=str(missing), partition_name="east",
        **{**CONFIG, "epochs": 1},
    )
    with pytest.raises(FileNotFoundError, match="nowhere.geojson"):
        fit(params, device="cpu")
    assert not (tmp_path / "last.ckpt").exists()
