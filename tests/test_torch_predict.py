"""The port's scene predict (cultionet_tpu_torch/predict.py) against the JAX
ScenePredictor's per-batch path, fp32 on the CPU."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import cultionet_tpu.predict as jax_predict
import cultionet_tpu_torch.predict as torch_predict
from cultionet_tpu.data import create as jax_create
from cultionet_tpu.data.batch import Batch
from cultionet_tpu.models import CultioNet as JaxCultioNet
from cultionet_tpu.train.step import TrainState
from cultionet_tpu_torch.data import create as torch_create
from cultionet_tpu_torch.models import CultioNet
from cultionet_tpu_torch.utils.params import load_flax

from torch_port_helpers import seeded_variables

IN_TIME = 6
WINDOW, PADDING = 20, 5


@pytest.mark.parametrize("window_size,padding", [(100, 20), (20, 5), (8, 0)])
def test_taper_weights(window_size, padding):
    got = torch_predict.taper_weights(window_size, padding).numpy()
    want = np.asarray(jax_predict.taper_weights(window_size, padding))
    assert got.shape == (window_size + 2 * padding,) * 2
    np.testing.assert_allclose(got, want, atol=1e-7)


@pytest.mark.parametrize("hw,window,padding", [((60, 60), 20, 5), ((45, 31), 20, 6)])
def test_window_jobs_match_jax(hw, window, padding):
    got = list(torch_create.iter_window_jobs(*hw, window, padding))
    assert got == list(jax_create.iter_window_jobs(*hw, window, padding))
    x = np.random.default_rng(0).random((2, *hw, 3)).astype("float32")
    for job in got:
        np.testing.assert_array_equal(
            torch_create._slice_window(x, job), jax_create._slice_window(x, job)
        )


def test_prepare_image_time_series_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.integers(-100, 12000, size=(3, 9, 8, 2)).astype("float64")
    x[0, 0, 0, 0] = np.nan
    np.testing.assert_array_equal(
        torch_create.prepare_image_time_series(x),
        jax_create.prepare_image_time_series(x, fill_zeros=False),
    )


@pytest.fixture(scope="module")
def predictors():
    jm = JaxCultioNet(
        in_time=IN_TIME, hidden_channels=8, dilations=[1, 2], dropout=0.2
    )
    size = WINDOW + 2 * PADDING
    variables = seeded_variables(
        jm, Batch(x=jnp.zeros((1, IN_TIME, size, size, 3))), training=False
    )
    state = TrainState.create(
        apply_fn=jm.apply,
        params=variables["params"],
        batch_stats=variables["batch_stats"],
        tx=optax.sgd(0.0),
    )
    model = CultioNet(in_time=IN_TIME, hidden_channels=8, dilations=[1, 2])
    load_flax(model, variables)
    return (
        jax_predict.ScenePredictor(state, batch_size=4, precision="fp32"),
        torch_predict.ScenePredictor(
            model, batch_size=4, precision="fp32", device="cpu"
        ),
    )


@pytest.mark.parametrize("packed", [True, False])
def test_predict_scene_matches_jax(predictors, packed):
    jax_predictor, torch_predictor = predictors
    rng = np.random.default_rng(2)
    scene = rng.random((IN_TIME, 60, 60, 3))
    if packed:
        scene = np.round(scene * 10000.0).astype("int16")
    else:
        scene = (scene * 1.2 - 0.1).astype("float32")  # exercises the clip

    want, want_hw = jax_predictor.predict_scene(
        scene, window_size=WINDOW, padding=PADDING, fused=False
    )
    got, got_hw = torch_predictor.predict_scene(
        scene, window_size=WINDOW, padding=PADDING
    )
    assert got_hw == want_hw == (60, 60)
    assert got.shape == (60, 60, 3) and got.dtype == np.float32
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


def test_predict_step_dequantizes_packed_input(predictors):
    _, torch_predictor = predictors
    rng = np.random.default_rng(3)
    x = rng.integers(0, 10000, size=(2, IN_TIME, 30, 30, 3)).astype("int16")
    packed = torch_predictor.predict_step(torch.from_numpy(x))
    scaled = torch_predictor.predict_step(
        torch.from_numpy(x.astype("float32")) * torch.tensor(1e-4)
    )
    for name in ("distance", "edge", "crop"):
        assert packed[name].dtype == torch.float32
        torch.testing.assert_close(packed[name], scaled[name], rtol=0, atol=0)
