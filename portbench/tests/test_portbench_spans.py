"""The per-layer metrics that read the program's spans and counters: in
a traced run of each cell on the CPU every one that the cell lists
reads a value (the copy counters read 0 there: the CPU has no card);
in an untraced run the program records no span."""

import json

import pytest

from portbench.testing import ROOT, run_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
# The metrics whose files read the program's spans and counters.
SPAN_METRICS = {
    m["name"]: m for m in BENCH["per_layer"]
    if "program_spans" in (ROOT / "portbench" / "metrics" / f"{m['name']}.py").read_text()
}
CELLS = ["train-conv-hbm", "predict-transformer-scene", "serve-conv-b8"]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_program_spans(tiny_root, capsys, cell):
    from cultionet_tpu_torch.utils import profiling

    profiling.reset()
    code, result, err = run_cell(tiny_root, cell, capsys, trace=1)
    assert code == 0, err
    listed = [n for n, m in SPAN_METRICS.items() if cell in m["workloads"]]
    assert len(listed) in (4, 6)
    for name in listed:
        value = result["metrics"][name]["value"]
        assert value >= 0, name
        if SPAN_METRICS[name]["source"] == "program_counter":
            assert value == 0, name
    times = [result["metrics"][n]["value"] for n in listed
             if SPAN_METRICS[n]["unit"] == "ms"]
    assert sum(times) > 0


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_run_records_no_span(tiny_root, capsys, cell):
    from cultionet_tpu_torch.utils import profiling

    profiling.reset()
    code, _, err = run_cell(tiny_root, cell, capsys, trace=0)
    assert code == 0, err
    assert profiling.totals() == {}
