"""The port's remaining small modules against the JAX package:
``utils/reshape.py::ModelOutputs`` (its ``stack_outputs`` equal to JAX's
exactly, over offsets, windows and non-finite values) and the project
config template ``scripts/config.yml`` (the JAX package's, read by the
port's CLI as ``<project>/config.yml``)."""

import numpy as np
import pytest

from cultionet_tpu.scripts import cli as jax_cli
from cultionet_tpu.utils.reshape import ModelOutputs as JaxModelOutputs
from cultionet_tpu_torch.scripts import cli
from cultionet_tpu_torch.utils.project_paths import setup_paths
from cultionet_tpu_torch.utils.reshape import ModelOutputs


def outputs(seed: int, shape=(23, 31), dtype="float64"):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(0.5, 0.7, shape).astype(dtype) for _ in range(3)]
    for a in arrays:
        a[rng.random(shape) < 0.05] = np.nan
        a[rng.random(shape) < 0.03] = np.inf
        a[rng.random(shape) < 0.03] = -np.inf
    return arrays


@pytest.mark.parametrize(
    "window",
    [{}, dict(row_off=3, col_off=5), dict(row_off=2, col_off=0, height=9, width=20),
     dict(row_off=20, col_off=28, height=9, width=9)],
)
@pytest.mark.parametrize("dtype", ["float64", "float32", "int16"])
def test_stack_outputs_matches_jax(window, dtype):
    arrays = outputs(len(window) + len(dtype), dtype="float64")
    if dtype == "int16":
        arrays = [np.nan_to_num(a, posinf=3, neginf=-3).astype(dtype) for a in arrays]
    got = ModelOutputs(*arrays, apply_softmax=True)
    want = JaxModelOutputs(*arrays, apply_softmax=True)
    assert got.apply_softmax == want.apply_softmax
    for name in ("distance", "edge", "crop"):
        assert getattr(got, name).dtype == getattr(want, name).dtype == np.float32
    stacked = got.stack_outputs(**window)
    expected = want.stack_outputs(**window)
    assert stacked.dtype == expected.dtype
    np.testing.assert_array_equal(stacked, expected)
    assert np.isfinite(stacked).all()
    assert stacked.min() >= 0 and stacked.max() <= 1


def test_config_template_is_the_jax_one(tmp_path):
    template = (cli.ARGS_SPEC.parent / "config.yml").read_text()
    assert template == (jax_cli.ARGS_SPEC.parent / "config.yml").read_text()
    project = tmp_path / "project"
    project.mkdir()
    (project / "config.yml").write_text(template)
    config = cli.read_project_config(setup_paths(project))
    assert config["image_vis"] == ["evi2", "gcvi", "kndvi"]
    assert config["regions"] is None
    assert (config["start_mmdd"], config["end_mmdd"]) == ("01-01", "12-31")
