"""``cultionet_tpu_torch/export.py::export_predictor`` over a port
checkpoint store on the CPU: the counterpart of each ``export_predictor``
case of ``tests/test_export.py`` (the round trip with the recorded pipeline
flags, a missing norm sidecar refused unless ``allow_unnormalized``, a
checkpoint without ``log_transform`` refused without an explicit choice,
a contradictory explicit choice refused, a stale sidecar ignored for a
model trained on raw input) and the log transform baked into the program,
on the tiny model of ``test_torch_export.py`` (in_time 5, hidden 4,
natten, dilations [1, 2], the port's initialization at seed 0) and the
JAX test's recorded hyperparameters.
"""

import json
import zipfile

import numpy as np
import pytest
import torch

from cultionet_tpu_torch.export import (
    build_serve_fn,
    export_predictor,
    export_state,
    load_predictor,
)
from cultionet_tpu_torch.models import CultioNet
from cultionet_tpu_torch.train.checkpoint import Checkpointer
from cultionet_tpu_torch.train.optim import build_optimizer
from cultionet_tpu_torch.train.step import create_train_state

NORM_MEAN = np.array([0.1, 0.2, 0.3], np.float32)
NORM_STD = np.array([1.1, 0.9, 1.2], np.float32)
IN_TIME = 5
X_SHAPE = (2, IN_TIME, 16, 16, 3)
LAT = np.array([45.0, 46.0], np.float32)
LON = np.array([-120.0, -119.0], np.float32)
MODEL_HP = {
    "in_time": IN_TIME,
    "hidden_channels": 4,
    "attention_weights": "natten",
    "dilations": [1, 2],
}
EXPORT = dict(batch_size=2, chip_size=16, precision="fp32", which="last",
              device="cpu")


@pytest.fixture(scope="module")
def tiny_state():
    model = CultioNet(**MODEL_HP)
    return create_train_state(
        model, build_optimizer("AdamW", 1e-3), seed=0, device="cpu"
    )


def _store(state, path, **flags):
    Checkpointer(path).save_last(
        state, epoch=0, hyperparams={**MODEL_HP, "in_channels": 3, **flags}
    )
    return path


@pytest.fixture(scope="module")
def ckpt_store(tiny_state, tmp_path_factory):
    return _store(
        tiny_state, tmp_path_factory.mktemp("ckpt") / "store",
        log_transform=False, normalized_input=True,
    )


@pytest.fixture(scope="module")
def norm_npz(tmp_path_factory):
    path = tmp_path_factory.mktemp("norm") / "norm.npz"
    np.savez(
        path, dataset_mean=NORM_MEAN, dataset_std=NORM_STD,
        dataset_crop_counts=np.array([10, 10]),
        dataset_edge_counts=np.array([10, 10]), num_channels=3,
    )
    return path


def test_export_predictor_roundtrip(ckpt_store, norm_npz, tmp_path):
    pred = load_predictor(
        export_predictor(
            ckpt_store, tmp_path / "serve.cnx", norm_file=norm_npz, **EXPORT
        )
    )
    assert pred.meta["normalized"] is True
    assert pred.meta["log_transform"] is False
    assert pred.meta["hyperparams"]["hidden_channels"] == 4
    x = np.random.default_rng(5).integers(0, 10000, size=X_SHAPE, dtype=np.int16)
    assert np.isfinite(pred(x, LAT, LON)["crop"]).all()


def test_export_predictor_missing_norm_raises(ckpt_store, tmp_path):
    with pytest.raises(ValueError, match="normaliz"):
        export_predictor(
            ckpt_store, tmp_path / "serve.cnx",
            norm_file=tmp_path / "does_not_exist.npz", **EXPORT,
        )


def test_export_predictor_allow_unnormalized(ckpt_store, tmp_path):
    out = export_predictor(
        ckpt_store, tmp_path / "serve.cnx", norm_file=None,
        allow_unnormalized=True, **EXPORT,
    )
    assert load_predictor(out).meta["normalized"] is False


def test_export_predictor_unknown_log_transform_raises(tiny_state, tmp_path):
    store = _store(tiny_state, tmp_path / "old_store")  # no pipeline flags
    with pytest.raises(ValueError, match="log_transform"):
        export_predictor(
            store, tmp_path / "serve.cnx", allow_unnormalized=True, **EXPORT
        )
    out = export_predictor(
        store, tmp_path / "serve2.cnx", log_transform=False,
        allow_unnormalized=True, **EXPORT,
    )
    assert load_predictor(out).meta["log_transform"] is False


def test_export_predictor_contradictory_log_transform_raises(
    ckpt_store, tmp_path
):
    with pytest.raises(ValueError, match="contradicts"):
        export_predictor(
            ckpt_store, tmp_path / "serve.cnx", log_transform=True,
            allow_unnormalized=True, **EXPORT,
        )


def test_export_predictor_ignores_stale_norm_for_raw_trained_model(
    tiny_state, norm_npz, tmp_path
):
    store = _store(
        tiny_state, tmp_path / "raw_store", log_transform=False,
        normalized_input=False,
    )
    out = export_predictor(
        store, tmp_path / "serve.cnx", norm_file=norm_npz, **EXPORT
    )
    assert load_predictor(out).meta["normalized"] is False


def test_log_transform_baked(tiny_state, tmp_path):
    """A log-trained model's artifact applies max(log(50 x + 1), 1e-9)
    before the z-score, and records the flag."""
    model = tiny_state.model
    artifact = export_state(
        model, tmp_path / "log.cnx", in_time=IN_TIME, in_channels=3,
        batch_size=2, chip_size=16, precision="fp32", device="cpu",
        norm_mean=NORM_MEAN, norm_std=NORM_STD, log_transform=True,
    )
    with zipfile.ZipFile(artifact) as zf:
        assert json.loads(zf.read("meta.json").decode())["log_transform"]
    x = np.random.default_rng(4).integers(0, 10000, size=X_SHAPE, dtype=np.int16)
    served = load_predictor(artifact)(x, LAT, LON)
    args = (torch.from_numpy(x), torch.from_numpy(LAT), torch.from_numpy(LON))
    with torch.no_grad():
        direct = build_serve_fn(
            model, NORM_MEAN, NORM_STD, precision="fp32", log_transform=True
        )(*args)
        plain = build_serve_fn(model, NORM_MEAN, NORM_STD, precision="fp32")(
            *args
        )
    for name, d in zip(("distance", "edge", "crop"), direct):
        np.testing.assert_allclose(served[name], d.numpy(), atol=1e-5)
    assert not np.allclose(direct[2].numpy(), plain[2].numpy())
