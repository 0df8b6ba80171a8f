"""Helpers of the benchmark's tests: the benchmark cut to a size the
CPU holds, and one in-process run of a cell."""

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def shrink(root: Path) -> None:
    """Cut every configuration and cell under ``root`` to a CPU size in
    fp32, keeping the limits."""
    for f in (root / "portbench" / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c["model"].update(hidden_channels=8, in_time=6)
        c["train"].update(batch_size=2, precision="32")
        f.write_text(json.dumps(c))
    for f in (root / "portbench" / "workloads").glob("*.json"):
        c = json.loads(f.read_text())
        tp = c["traffic_params"]
        tp.update(time=6)
        if "chip_size" in tp:
            tp.update(chips=16, chip_size=32)
        if "scene_size" in tp:
            tp.update(scene_size=96, window=24, padding=4, batch=4,
                      precision="fp32", sample_blocks=2, scene_pool=2)
        if "pool" in tp:
            tp.update(window=32, batch=2, pool=3, precision="fp32", compared_calls=3)
        c["trace"] = {"span": 1, "every": 2}
        f.write_text(json.dumps(c))


def register_all_cells(root: Path) -> None:
    """Enter every cell file under ``root`` in its BENCHMARK.json, with
    the metrics of a listed cell of the same driver (a cell kept as a file
    but not yet in the benchmark still runs in the tests)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    listed = {w["name"] for w in bench["workloads"]}
    for f in sorted((root / "portbench" / "workloads").glob("*.json")):
        cell = json.loads(f.read_text())
        if cell["name"] in listed:
            continue
        twin = next(
            w["name"] for w in bench["workloads"]
            if json.loads((root / "portbench" / "workloads" / f"{w['name']}.json")
                          .read_text())["driver"] == cell["driver"]
        )
        bench["workloads"].append({k: cell[k] for k in ("name", "config", "traffic", "chips", "why")})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if twin in m.get("workloads", []):
                m["workloads"].append(cell["name"])
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def run_cell(root: Path, cell: str, capsys, trace: int = 0, seed: int = 2**31 + 19):
    """Run ``cell`` on the CPU from ``root``; (exit code, result, stderr)."""
    from portbench import harness

    code = harness.main(
        ["--workload", cell, "--seed", str(seed), "--seconds", "1",
         "--trace", str(trace)],
        root=root, device="cpu",
    )
    captured = capsys.readouterr()
    lines = captured.out.strip().splitlines()
    result = json.loads(lines[-1]) if code == 0 and lines else None
    return code, result, captured.err
