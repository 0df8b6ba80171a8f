"""On the card, at each cell's own size: the control (the reference in
the program's place, computed in fp8) fails at least one of the cell's
limits, and so does a train cell's fault of half the batch left out.
Run on a machine with a card: ``python3 -m pytest portbench/tests -m card``."""

import json

import pytest
import torch

from portbench import control
from portbench.testing import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 2**31 + 4099


def _cell(name):
    cell = json.loads((ROOT / "portbench" / "workloads" / f"{name}.json").read_text())
    entry = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    return cell, json.loads((ROOT / entry["file"]).read_text())


def _fails(readings, limits):
    return any(readings[k] > limits[k] for k in limits)


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_control_and_faults_fail_the_limits(card, name):
    cell, config = _cell(name)
    device = torch.device("cuda:0")
    if cell["driver"] == "train":
        out = control.train_readings(cell, config, SEED, device)
        assert _fails(out["half_batch"], cell["limits"]), out
    else:
        out = control.forward_readings(cell, config, SEED, device)
    assert _fails(out["control"], cell["limits"]), out
