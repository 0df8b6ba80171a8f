"""The port's multi-device predict (``ScenePredictor(devices=N)``: a model
replica per device, each window batch split into equal blocks) on the
CPU, against ``devices=1`` and against the JAX ``ScenePredictor(devices=2)``
on two host devices, from the same weights; and CLI ``predict --devices
2``.

- A 70 x 110 scene cut into 40 + 2 x 8 windows (12 windows, batch 8 and
  an odd batch 7 rounded up to 8: the last batch's padded slots are
  dropped): the blended raster of ``devices=2`` equals ``devices=1``'s
  within JAX's own tolerance (rtol 1e-4, atol 1e-5,
  ``tests/test_predict_parallel.py``), from window chips and from the
  in-memory scene; and JAX's ``devices=2`` raster within 1e-4 (the port's
  and JAX's forwards differ by fp32 round-off, ``test_torch_predict.py``).
  Hidden 4, dilation 1, no attention, so JAX compiles quickly.
- CLI ``predict --devices 2`` over the golden scene's window chips with
  the conv golden checkpoint converted by ``convert_orbax.py``: the
  GeoTIFF equals ``--devices 1``'s on at least 99.9% of its pixels, and
  ``golden.tif`` too.
"""

import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from cultionet_tpu.data.batch import Batch as JaxBatch
from cultionet_tpu.data.create import create_predict_dataset
from cultionet_tpu.data.datasets import ChipDataset as JaxDataset
from cultionet_tpu.models import CultioNet as JaxCultioNet
from cultionet_tpu.predict import ScenePredictor as JaxScenePredictor
from cultionet_tpu.train import optim as jax_optim
from cultionet_tpu.train import step as jax_step
from cultionet_tpu_torch.data.datasets import ChipDataset
from cultionet_tpu_torch.models import CultioNet
from cultionet_tpu_torch.predict import ScenePredictor
from cultionet_tpu_torch.scripts import cli
from cultionet_tpu_torch.utils.params import load_flax

from convert_orbax import convert
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    one_torch_thread,
    seeded_variables,
)

MODEL = dict(in_time=6, hidden_channels=4, dilations=[1],
             attention_weights=None, dropout=0.0)
GOLDEN = Path(__file__).parent / "data" / "golden"


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("scene")
    x = np.random.default_rng(2).random((6, 70, 110, 2)).astype("float32")
    create_predict_dataset(
        image_time_series=x, region="r1",
        process_path=tmp / "predict" / "processed", window_size=40,
        padding=8, num_workers=1,
    )
    jax_model = JaxCultioNet(**MODEL)
    variables = seeded_variables(
        jax_model, JaxBatch(x=jnp.zeros((1, 6, 56, 56, 2))), training=False,
        seed=4,
    )
    model = load_flax(CultioNet(in_channels=2, **MODEL), variables)
    return tmp / "predict", x, jax_model, variables, model


@pytest.mark.parametrize("batch_size", [8, 7])
def test_two_devices_match_one(scene, batch_size):
    root, x, _, _, model = scene
    one = ScenePredictor(model, batch_size=8, device="cpu")
    two = ScenePredictor(model, batch_size=batch_size, device="cpu",
                         devices=2)
    assert two.batch_size == 8
    want, dims = one.predict_windows(ChipDataset(root))
    got, got_dims = two.predict_windows(ChipDataset(root))
    assert dims == got_dims == (70, 110)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    want, _ = one.predict_scene(x, window_size=40, padding=8)
    got, _ = two.predict_scene(x, window_size=40, padding=8)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_two_devices_match_jax(scene):
    root, _, jax_model, variables, model = scene
    state = jax_step.TrainState.create(
        apply_fn=jax_model.apply,
        params=variables["params"],
        batch_stats=variables["batch_stats"],
        tx=jax_optim.build_optimizer("AdamW", 1e-3),
    )
    want, dims = JaxScenePredictor(
        state, batch_size=8, devices=2
    ).predict_windows(JaxDataset(root))
    got, got_dims = ScenePredictor(
        model, batch_size=8, device="cpu", devices=2
    ).predict_windows(ChipDataset(root))
    assert dims == got_dims
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


def test_cli_predict_on_two_devices(tmp_path):
    from cultionet_tpu_torch.data.tiny_tiff import read_tiff

    project = tmp_path / "project"
    region = project / "time_series_vars" / "golden"
    region.mkdir(parents=True)
    shutil.copy(GOLDEN / "scene.npz", region / "scene.npz")
    convert(GOLDEN / "ckpt" / "last_store", project / "ckpt" / "last_store")
    cli.main(
        ["create-predict", "-p", str(project), "--window-size", "50",
         "--padding", "10", "--num-workers", "1"],
        device="cpu",
    )
    rasters = {}
    for devices in (1, 2):
        out = project / "out" / f"golden{devices}.tif"
        cli.main(
            ["predict", "-p", str(project), "--region", "golden", "-o",
             str(out), "--predict-batch-size", "3", "--devices",
             str(devices)],
            device="cpu",
        )
        rasters[devices] = read_tiff(out)[0]
    golden = read_tiff(GOLDEN / "golden.tif")[0]
    assert rasters[2].shape == golden.shape == (3, 100, 100)
    assert float(np.mean(rasters[2] == rasters[1])) >= 0.999
    assert float(np.mean(rasters[2] == golden)) >= 0.999
