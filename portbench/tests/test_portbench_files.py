"""Every cell, configuration, driver and metric file loads, names what
BENCHMARK.json names, and keeps to the contract's characters and sizes;
a new cell and a new metric run as new files alone."""

import json
import re

import pytest

from portbench.testing import ROOT, run_cell
from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]


def line_ok(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_keys_and_limits():
    assert set(BENCH) == {
        "command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer",
    }
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert BENCH["paths"] == ["portbench"]
    assert all(line_ok(w) for w in BENCH["command"])
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    every = CELLS + [c["name"] for c in BENCH["configs"]] + names + METRICS
    assert len(every) == len(set(every))
    assert all(NAME.match(n) for n in every)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_file(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert entry["chips"] == 1 and line_ok(entry["why"]) and NAME.match(entry["traffic"])
    data = json.loads((ROOT / "portbench" / "workloads" / f"{cell}.json").read_text())
    assert data["name"] == cell and data["config"] == entry["config"]
    assert (ROOT / "portbench" / "drivers" / f"{data['driver']}.py").is_file()
    assert set(data["limits"]) and all(v < 1e8 for v in data["limits"].values())
    reported = harness.cell_metrics(BENCH, cell, per_layer=False)
    assert any(m["name"] != "setup_s" for m in reported)
    assert harness.cell_metrics(BENCH, cell, per_layer=True)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["file"].startswith("portbench/configs/")
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["model"]["hidden_channels"] == 64 and config["reduced"] == []
    assert line_ok(config["source"]) and line_ok(config["why"])
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("name", METRICS)
def test_metric_file(name):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    module = harness.load_module(ROOT / "portbench" / "metrics" / f"{name}.py", "m_" + name)
    assert (module.LAYER, module.UNIT, module.BETTER, module.SOURCE, module.MOVES) == (
        entry["layer"], entry["unit"], entry["better"], entry["source"], entry["moves"]
    )
    assert module.WORKLOADS == entry["workloads"] and set(entry["workloads"]) <= set(CELLS)
    assert UNIT.match(entry["unit"]) and line_ok(entry["layer"])
    moved = next(m for m in BENCH["end_to_end"] if m["name"] == entry["moves"])
    assert set(entry["workloads"]) <= set(moved["workloads"])
    if "roofline" in name or "mfu" in name or "idle" in name:
        assert entry["unit"] == "%"


def test_new_cell_and_metric_are_files_alone(tiny_root, capsys):
    """A cell and a metric added as new files (and entries in
    BENCHMARK.json) run with no other file edited."""
    before = {p: p.read_bytes() for p in (tiny_root / "portbench").rglob("*") if p.is_file()}
    cell = json.loads((tiny_root / "portbench/workloads/serve-conv-b8.json").read_text())
    cell.update(name="serve-conv-b2-extra")
    cell["traffic_params"]["pool"] = 2
    (tiny_root / "portbench/workloads/serve-conv-b2-extra.json").write_text(json.dumps(cell))
    (tiny_root / "portbench/metrics/calls.serve.py").write_text(
        'LAYER = "serve"\nUNIT, BETTER, SOURCE, MOVES = "calls", "higher", "program_counter", "serve_p95_ms"\n'
        'WORKLOADS = ["serve-conv-b2-extra"]\n\n\ndef read(ctx):\n    return ctx.units\n'
    )
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "serve-conv-b2-extra", "config": "cultionet-cli-conv",
                               "traffic": "wire-b2-extra", "chips": 1, "why": "test"})
    bench["end_to_end"][2]["workloads"].append("serve-conv-b2-extra")
    bench["per_layer"].append({"name": "calls.serve", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "serve",
                               "moves": "serve_p95_ms", "workloads": ["serve-conv-b2-extra"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    code, result, _ = run_cell(tiny_root, "serve-conv-b2-extra", capsys, trace=1)
    assert code == 0 and result["correct"]
    assert result["metrics"]["calls.serve"]["value"] > 0
    after = {p: p.read_bytes() for p in before}
    assert after == before
