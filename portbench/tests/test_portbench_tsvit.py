"""The TSViT cell (``train-tsvit-pastis24``) on the CPU at a tiny size:
the PASTIS24 traffic repeats by seed and keeps its shapes, the operation
count is linear in the batch, a run comes out correct, and each fault of
the program (the state left unchanged, half of the batch) and the
control fail a limit."""

import json

import numpy as np
import pytest
import torch

from portbench.drivers import train_tsvit
from portbench.roofline_tsvit import count_tsvit
from portbench.testing import ROOT, run_cell
from portbench.traffic.pastis import VOID, pastis_patches

CELL = "train-tsvit-pastis24"
CONFIG = json.loads((ROOT / "portbench" / "configs" / "tsvit-pastis24.json").read_text())
TILES = dict(chips=6, chip_size=24, time=60, min_time=38, day_span=430, bands=10,
             void_share=0.3)


@pytest.fixture
def tsvit_root(tiny_root):
    """The tiny benchmark with a narrower TSViT (width 32, two layers an
    encoder) on 16 x 16 tiles of 2 to 10 dates, batch 4, so pad dates are
    a large share of the compared batches."""
    path = tiny_root / "portbench" / "workloads" / f"{CELL}.json"
    cell = json.loads(path.read_text())
    cell["traffic_params"].update(chip_size=16, time=10, min_time=2)
    path.write_text(json.dumps(cell))
    path = tiny_root / "portbench" / "configs" / "tsvit-pastis24.json"
    config = json.loads(path.read_text())
    config["model"].update(dim=32, dim_head=8, temporal_depth=2, spatial_depth=2)
    config["train"].update(batch_size=4)
    path.write_text(json.dumps(config))
    return tiny_root


def test_tiles_repeat_by_seed_and_keep_the_shapes():
    a = pastis_patches(TILES, 2**31 + 5, "cpu")
    b = pastis_patches(TILES, 2**31 + 5, "cpu")
    c = pastis_patches(TILES, 11, "cpu")
    for k in ("x", "y", "dates", "date_count"):
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
        assert np.asarray(a[k]).shape == np.asarray(c[k]).shape, k
    assert a["x"].shape == (6, 60, 24, 24, 10) and a["x"].dtype == torch.int16
    counts = a["date_count"]
    assert counts.min() >= 38 and counts.max() <= 60
    for i, n in enumerate(counts):
        assert np.all(np.diff(a["dates"][i, :n]) > 0) and a["dates"][i, :n].max() < 430
        assert torch.all(a["x"][i, n:] == 0)
    assert set(np.unique(a["y"])) <= set(range(VOID + 1)) and VOID in a["y"]


def test_count_is_linear_in_the_batch():
    model = CONFIG["model"]
    one, three = count_tsvit(model, 1, 60), count_tsvit(model, 3, 60)
    assert three.flops() == 3 * one.flops()
    # Published widths at batch 16: about 1.2 TFLOP a step, the temporal
    # encoder's four layers over 16 x 144 sequences of 19 + 60 tokens.
    sixteen = count_tsvit(model, 16, 60)
    assert 1.19e12 < sixteen.flops() < 1.20e12
    assert sixteen.temporal_sites == [(2304, 79, 79, 128, 4, 2304)] * 4
    # One temporal layer's projections alone: 2 x 2304 x 79 x 128 x (384
    # + 128 + 2 x 512) a forward, three times that with the backward.
    assert sixteen.flops() > 4 * 3 * 2 * 2304 * 79 * 128 * (384 + 128 + 1024)
    assert sixteen.temporal_least_seconds(2, True) > sixteen.temporal_least_seconds(2, False) > 0


def test_run_is_correct(tsvit_root, capsys):
    code, result, err = run_cell(tsvit_root, CELL, capsys, trace=1)
    assert code == 0, err
    assert result["correct"] is True, result["checks"]
    assert set(result["checks"]) == {"first_grad_median_gap", "change_gap"}


def _unchanged_state(monkeypatch):
    from cultionet_tpu_torch.train.optim import Optimizer

    def step(self):
        self.zero_grad()
        return False

    monkeypatch.setattr(Optimizer, "step", step)


def _half_batch(monkeypatch):
    from cultionet_tpu_torch.train import step as step_module

    original = step_module.forward_loss

    def forward_loss(model, batch, *args, **kwargs):
        half = batch.x.shape[0] // 2
        batch = batch.replace(x=batch.x[:half], y=batch.y[:half], dates=batch.dates[:half],
                              date_count=batch.date_count[:half])
        return original(model, batch, *args, **kwargs)

    monkeypatch.setattr(step_module, "forward_loss", forward_loss)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch],
                         ids=lambda f: f.__name__[1:])
def test_fault_is_not_correct(tsvit_root, capsys, monkeypatch, fault):
    fault(monkeypatch)
    code, result, err = run_cell(tsvit_root, CELL, capsys)
    assert code == 0, err
    assert result["correct"] is False, result["checks"]


def test_control_and_reference_faults_fail_a_limit(tsvit_root):
    cell = json.loads((tsvit_root / "portbench" / "workloads" / f"{CELL}.json").read_text())
    config = json.loads((tsvit_root / "portbench" / "configs" / "tsvit-pastis24.json").read_text())
    out = train_tsvit.control_readings(cell, config, 2**31 + 23, torch.device("cpu"))
    limits = cell["limits"]
    for name in ("control", "half_batch", "unchanged"):
        assert any(out[name][k] > limits[k] for k in limits), (name, out[name])

