#!/usr/bin/env python3
"""Device times of the temporal-attention kernels (#5 temporal_fwd, #6
temporal_bwd) of several checkouts of this repository, in turns, on one
NVIDIA GPU.

    python3 temporal_kernels_ab.py ROOT[@NAME=VALUE,...] [ROOT ...]

Each ROOT is a directory that holds a checkout's ``cultionet_tpu_torch``
package (for example the parent commit's, unpacked with ``git archive``
into a directory that ``.gitignore`` lists). Give the roots in turns
(parent, change, change, parent) to see the card drift between them. Each
runs in a process of its own, which builds that checkout's kernels and
times both kernels in bf16 at ``chip_smoke.TEMPORAL_ROWS`` (the layer and
pooling calls of the predict and train paths, inputs made as the
transformer makes them) with this checkout's ``chip_smoke.device_ms``
(calls queued back to back on the card) and ``chip_smoke.median_ms``
(single calls, host dispatch included). ``@NAME=VALUE`` sets module
constants of that root's ``ops/temporal_cuda.py`` before timing (tile
planner settings such as ``_MMA_ITEMS=16`` or ``_MMA_MIN_QUERY_STEPS=1``),
for comparing plans of one checkout. It prints the card's name and power
limit, then one JSON line per root, kernel and call.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _smoke():
    """This checkout's chip_smoke.py, whatever package ``sys.path`` finds."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", HERE / "chip_smoke.py"
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _settings(text: str) -> dict:
    pairs = [item.split("=", 1) for item in text.split(",") if item]
    return {name: int(value) for name, value in pairs}


def time_root(root: Path, settings: dict) -> None:
    sys.path.insert(0, str(root))
    import torch

    from cultionet_tpu_torch.ops import temporal_cuda

    package = Path(temporal_cuda.__file__).resolve()
    if root not in package.parents:
        raise RuntimeError(f"imported {package}, not the package in {root}")
    for name, value in settings.items():
        if not hasattr(temporal_cuda, name):
            raise AttributeError(f"{root}: temporal_cuda has no {name}")
        setattr(temporal_cuda, name, value)
    if settings:
        temporal_cuda._tile_plan.cache_clear()
    smoke = _smoke()
    gen = torch.Generator(device="cuda").manual_seed(6)
    for row in smoke.TEMPORAL_ROWS:
        heads = row[5]
        q, k, v = smoke.temporal_inputs(row, torch.bfloat16, gen)
        g = torch.randn(q.shape, device="cuda", generator=gen).to(q.dtype)
        calls = {
            "temporal_fwd": (
                lambda: temporal_cuda.launch_temporal_fwd(q, k, v, heads),
                False,
            ),
            "temporal_bwd": (
                lambda: temporal_cuda.launch_temporal_bwd(q, k, v, g, heads),
                True,
            ),
        }
        for name, (fn, backward) in calls.items():
            bound, _ = smoke.temporal_bound_ms(row, q, backward)
            record = {
                "root": str(root),
                "settings": settings,
                "kernel": name,
                "call": row[0],
                "dtype": "bfloat16",
                "ms": smoke.device_ms(fn),
                "call_ms": smoke.median_ms(fn),
                "bound_ms": bound,
            }
            record["share_of_bound"] = bound / record["ms"]
            print(json.dumps(record), flush=True)
        del q, k, v, g


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--root":
        time_root(Path(argv[1]).resolve(), _settings(argv[2]))
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    for spec in argv:
        root, _, settings = spec.partition("@")
        subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--root", root,
             settings],
            check=True,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
