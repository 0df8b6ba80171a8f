"""The control at a CPU size: the reference computed in fp8 in the
program's place fails at least one of each cell's limits (the card test
holds the same at each cell's own size)."""

import json

import pytest
import torch

from portbench import control
from portbench.testing import ROOT

CELLS = sorted(p.stem for p in (ROOT / "portbench" / "workloads").glob("*.json"))


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_a_limit(tiny_root, name):
    cell = json.loads((tiny_root / "portbench" / "workloads" / f"{name}.json").read_text())
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((tiny_root / entry["file"]).read_text())
    device = torch.device("cpu")
    if cell["driver"] == "train":
        out = control.train_readings(cell, config, 2**31 + 23, device)
    else:
        out = control.forward_readings(cell, config, 2**31 + 23, device)
    limits = cell["limits"]
    assert any(out["control"][k] > limits[k] for k in limits), out
