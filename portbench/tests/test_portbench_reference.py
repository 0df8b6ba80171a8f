"""The reference agrees with the program at a tiny size on the CPU, and
every cell runs end to end there, correct, with the contract's keys."""

import json
import subprocess
import sys

import pytest
import torch

from portbench.testing import ROOT, run_cell
from portbench.weights import reference_model, seeded_state

CELLS = sorted(p.stem for p in (ROOT / "portbench" / "workloads").glob("*.json"))


@pytest.mark.parametrize("encoder", ["conv", "transformer"])
def test_reference_forward_matches_program(encoder):
    from cultionet_tpu_torch.models import CultioNet

    config = {"model": dict(in_time=6, in_channels=3, hidden_channels=8, dropout=0.2,
                            dilations=[1, 2], attention_weights="natten",
                            temporal_encoder=encoder)}
    ref = reference_model(config, "cpu")
    x = torch.rand(2, 6, 32, 32, 3)
    state = seeded_state(ref, 2**31 + 3, x)
    program = CultioNet(**config["model"])
    program.load_state_dict(state)
    program.eval()
    with torch.no_grad():
        want, got = ref(x), program(x)
    for name in ("distance", "edge", "crop"):
        assert torch.allclose(got[name], want[name], atol=1e-5, rtol=0)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct(tiny_root, capsys, cell, trace):
    code, result, err = run_cell(tiny_root, cell, capsys, trace=trace)
    assert code == 0, err
    assert result["correct"] is True and result["failed"] == 0
    allowed = {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert set(result) == allowed | ({"breakdown"} if trace else set())
    assert list(result)[-1] == "checks"
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        e2e = [m["name"] for m in bench["end_to_end"]
               if "workloads" not in m or cell in m["workloads"]]
        assert set(result["metrics"]) == set(e2e)
    # Each number compared is printed beside its limit, last on stderr.
    tail = err.strip().splitlines()[-len(result["checks"]):]
    assert all(line.startswith("check ") and " limit " in line for line in tail)


def test_no_card_exits_nonzero_without_a_result():
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "serve-conv-b8",
         "--seed", str(2**31 + 1), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert proc.returncode != 0
    assert "{" not in proc.stdout and "no CUDA card" in proc.stderr
