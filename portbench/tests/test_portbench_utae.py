"""The U-TAE cell (``train-utae-pastis``) on the CPU at a tiny size: its
traffic repeats by seed and keeps PASTIS's shapes, its operation count is
linear in the real date images, a run comes out correct with the padding
counted, and each fault of the program (the state left unchanged, half of
the batch, pad dates left unmasked) and the control fail a limit."""

import json

import numpy as np
import pytest
import torch

from portbench.drivers import train_utae
from portbench.roofline_utae import _step_on_meta, count_utae
from portbench.testing import ROOT, run_cell
from portbench.traffic.pastis import VOID, pastis_patches

CELL = "train-utae-pastis"
PATCHES = dict(chips=5, chip_size=32, time=8, min_time=3, day_span=430, bands=10,
               void_share=0.3)


@pytest.fixture
def utae_root(tiny_root):
    """The tiny benchmark with padding in the U-TAE cell: 2 to 10 dates a
    patch (the shrunk cell has 6 of 6), so that pad dates are a large share
    of the compared batches."""
    path = tiny_root / "portbench" / "workloads" / f"{CELL}.json"
    cell = json.loads(path.read_text())
    cell["traffic_params"].update(time=10, min_time=2)
    path.write_text(json.dumps(cell))
    return tiny_root


def test_patches_repeat_by_seed_and_keep_the_shapes():
    a = pastis_patches(PATCHES, 2**31 + 5, "cpu")
    b = pastis_patches(PATCHES, 2**31 + 5, "cpu")
    c = pastis_patches(PATCHES, 7, "cpu")
    for k in ("x", "y", "dates", "date_count"):
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
        assert np.asarray(a[k]).shape == np.asarray(c[k]).shape, k
    assert not torch.equal(a["x"], c["x"])
    assert a["x"].shape == (5, 8, 32, 32, 10) and a["x"].dtype == torch.int16
    counts = a["date_count"]
    assert counts.min() >= 3 and counts.max() <= 8
    for i, n in enumerate(counts):
        days = a["dates"][i]
        assert np.all(np.diff(days[:n]) > 0) and days[:n].max() < 430
        assert np.all(days[n:] == 0)
        assert torch.all(a["x"][i, n:] == 0) and torch.any(a["x"][i, :n] != 0)
    assert set(np.unique(a["y"])) <= set(range(VOID + 1)) and 0 in a["y"]
    assert VOID in a["y"] and np.any((a["y"] > 0) & (a["y"] < VOID))


def test_count_is_linear_in_real_dates():
    model = json.loads((ROOT / "portbench" / "configs" / "utae-pastis.json").read_text())["model"]
    counts = count_utae(model, batch=2, steps=5, size=32, real_images=7)
    assert counts.flops() == counts.fixed_flops + 7 * counts.image_flops
    # Three dates a chip, every date real: fixed plus six images.
    three = _step_on_meta(model, 2, 3, 32)
    assert abs(three - (counts.fixed_flops + 6 * counts.image_flops)) <= 1e-9 * three
    # The encoder's first convolution alone: 2 x 10 x 64 x 9 x 32^2 a
    # forward, twice that for its weight's gradient.
    assert counts.image_flops > 3 * 2 * 10 * 64 * 9 * 32 * 32
    assert len(counts.groupnorm_shapes) == 13
    assert counts.groupnorm_shapes[0] == (10, 64, 32, 32)
    assert counts.groupnorm_bytes(2) == sum(5 * 2 * np.prod(s) for s in counts.groupnorm_shapes)


def test_run_counts_the_padding(utae_root, capsys):
    code, result, err = run_cell(utae_root, CELL, capsys, trace=1)
    assert code == 0, err
    assert result["correct"] is True, result["checks"]
    share = result["metrics"]["utae.pad_share.train"]["value"]
    assert 0 < share < 100


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


def _unmasked_pads(monkeypatch):
    from cultionet_tpu_torch.models import utae

    def every_date(date_count, steps, batch, device):
        return torch.ones((batch, steps), dtype=torch.bool, device=device)

    monkeypatch.setattr(utae, "date_mask", every_date)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch, _unmasked_pads],
                         ids=lambda f: f.__name__[1:])
def test_fault_is_not_correct(utae_root, capsys, monkeypatch, fault):
    fault(monkeypatch)
    code, result, err = run_cell(utae_root, CELL, capsys)
    assert code == 0, err
    assert result["correct"] is False, result["checks"]


def test_control_and_reference_faults_fail_a_limit(utae_root):
    cell = json.loads((utae_root / "portbench" / "workloads" / f"{CELL}.json").read_text())
    config = json.loads((utae_root / "portbench" / "configs" / "utae-pastis.json").read_text())
    out = train_utae.control_readings(cell, config, 2**31 + 23, torch.device("cpu"))
    limits = cell["limits"]
    for name in ("control", "half_batch", "unmasked", "unchanged"):
        assert any(out[name][k] > limits[k] for k in limits), (name, out[name])
