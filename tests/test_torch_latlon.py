"""The chips' coordinates on the predict and serving paths of a
``use_latlon`` model, on the CPU, port only (hidden 4, T = 5):

- ``ScenePredictor.predict_scene`` gives every window the centroid of the
  scene's bounds, ``(0, 0, 1, 1)`` without them (the JAX predictor's
  default); other bounds give other rasters.
- ``model.predict`` over chip files passes each chip's centroid.
- A bf16 CPU artifact serves exactly what the eager serve program computes
  (0.0), and two coordinate batches give two different outputs.
"""

import numpy as np
import pytest
import torch

from cultionet_tpu_torch.data.datasets import ChipDataset
from cultionet_tpu_torch.data.synthetic import create_batch
from cultionet_tpu_torch.export import (
    build_serve_fn,
    export_state,
    load_predictor,
)
from cultionet_tpu_torch.model import predict
from cultionet_tpu_torch.models import CultioNet
from cultionet_tpu_torch.nn.init import init_parameters_
from cultionet_tpu_torch.predict import ScenePredictor

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

OUTPUTS = ("distance", "edge", "crop")
IN_TIME = 5


@pytest.fixture(scope="module")
def model():
    model = CultioNet(
        in_time=IN_TIME, in_channels=3, hidden_channels=4, dilations=[1, 2],
        use_latlon=True,
    )
    init_parameters_(model, torch.Generator().manual_seed(0))
    return model.eval()


def test_predict_scene_passes_the_bounds_centroid(model):
    scene = np.random.default_rng(0).integers(
        0, 10000, (IN_TIME, 40, 40, 3), dtype=np.int16
    )
    predictor = ScenePredictor(model, batch_size=4, device="cpu")
    seen = []
    step = predictor.predict_step

    def spy(x, lat, lon):
        seen.append((np.asarray(lat), np.asarray(lon)))
        return step(x, lat, lon)

    predictor.predict_step = spy
    bounds = (10.0, 20.0, 30.0, 40.0)
    raster, _ = predictor.predict_scene(
        scene, window_size=16, padding=4, bounds=bounds
    )
    assert predictor._scene_bounds == bounds
    assert seen and all(
        (lat == np.float32(30.0)).all() and (lon == np.float32(20.0)).all()
        and lat.dtype == lon.dtype == np.float32
        for lat, lon in seen
    )
    default, _ = predictor.predict_scene(scene, window_size=16, padding=4)
    unit, _ = predictor.predict_scene(
        scene, window_size=16, padding=4, bounds=(0.0, 0.0, 1.0, 1.0)
    )
    np.testing.assert_array_equal(default, unit)
    assert np.abs(raster - default).max() > 1e-4


def test_model_predict_passes_chip_centroids(model, tmp_path):
    batch = create_batch(
        num_channels=3, num_time=IN_TIME, height=16, width=16, batch_size=1,
        rng=np.random.default_rng(1),
    )
    batch.to_file(tmp_path / "processed" / batch.batch_id[0])
    dataset = ChipDataset(tmp_path)
    (got,) = predict(model, dataset, batch_size=1, device="cpu")
    chip = dataset[0]
    assert chip.lat is not None and chip.lon is not None
    with torch.no_grad():
        want = model(chip.x, chip.lat, chip.lon)
        other = model(chip.x, chip.lat + 10.0, chip.lon)
    for name in OUTPUTS:
        np.testing.assert_allclose(got[name], want[name].numpy(), atol=1e-6)
    assert max(
        float((want[n] - other[n]).abs().max()) for n in OUTPUTS
    ) > 1e-4


def test_served_artifact_equals_in_process(model, tmp_path):
    artifact = export_state(
        model, tmp_path / "latlon.cnx", in_time=IN_TIME, in_channels=3,
        batch_size=2, chip_size=16, precision="bf16", device="cpu",
    )
    served = load_predictor(artifact)
    serve = build_serve_fn(model, precision="bf16")
    x = np.random.default_rng(2).integers(
        0, 10000, (2, IN_TIME, 16, 16, 3), dtype=np.int16
    )
    coords = [  # two (lat, lon) batches for the two chips
        (np.float32([45.0, -12.5]), np.float32([-120.0, 30.0])),
        (np.float32([-33.0, 60.0]), np.float32([150.0, 5.0])),
    ]
    outputs = []
    for lat, lon in coords:
        got = served(x, lat, lon)
        with torch.no_grad():
            want = serve(*(torch.from_numpy(a) for a in (x, lat, lon)))
        for name, value in zip(OUTPUTS, want):
            assert got[name].dtype == np.float32
            np.testing.assert_array_equal(got[name], value.numpy())
        outputs.append(got)
    assert max(
        float(np.abs(outputs[0][n] - outputs[1][n]).max()) for n in OUTPUTS
    ) > 1e-4
