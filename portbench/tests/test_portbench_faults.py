"""A run whose timed path is broken underneath comes out not correct:
one case for each fault the cell can have (a train step that leaves the
state as it was; half of the batch left out, the mean taken over the
rest; an answer altered where it is produced). The look for a card is
skipped; the rest of the run is the benchmark's, at a CPU size."""

import pytest

from portbench.testing import run_cell


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
        batch = batch.replace(x=batch.x[:half], y=batch.y[:half], bdist=batch.bdist[:half])
        return original(model, batch, *args, **kwargs)

    monkeypatch.setattr(step_module, "forward_loss", forward_loss)


def _altered_prediction(monkeypatch):
    from cultionet_tpu_torch.train import step as step_module

    original = step_module._inference_apply

    def apply(*args, **kwargs):
        out = original(*args, **kwargs)
        out["edge"] = (out["edge"] + 0.5).clamp(0, 1)
        return out

    monkeypatch.setattr(step_module, "_inference_apply", apply)


def _altered_served(monkeypatch):
    from cultionet_tpu_torch.export import ExportedPredictor

    original = ExportedPredictor.call_on_device

    def call(self, x, lat, lon):
        distance, edge, crop = original(self, x, lat, lon)
        return distance, (edge + 0.5).clamp(0, 1), crop

    monkeypatch.setattr(ExportedPredictor, "call_on_device", call)


FAULTS = [
    ("train-conv-hbm", _unchanged_state),
    ("train-conv-hbm", _half_batch),
    ("train-conv-files", _unchanged_state),
    ("train-conv-files", _half_batch),
    ("predict-transformer-scene", _altered_prediction),
    ("serve-conv-b8", _altered_served),
]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_fault_is_not_correct(tiny_root, capsys, monkeypatch, cell, fault):
    fault(monkeypatch)
    code, result, err = run_cell(tiny_root, cell, capsys)
    assert code == 0, err
    assert result["correct"] is False, result["checks"]
