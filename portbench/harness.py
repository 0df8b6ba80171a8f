"""The benchmark's harness: one run of one cell.

``main`` reads the cell (``workloads/<cell>.json``), its configuration
(``configs/<config>.json``) and ``BENCHMARK.json``, checks for the cards
the cell asks for, loads the cell's driver (``drivers/<driver>.py``) and
runs it: set-up, warm-up, the measured window, and the comparison with
the plain reference. It then reads each per-layer metric of the cell
(``metrics/<metric>.py``) in a traced run, and prints one JSON line.
Cells, configurations, drivers and metrics are found by name, so a new
one is a new file and an entry in ``BENCHMARK.json``.
"""

import argparse
import dataclasses
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import typing as T
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "cultionet_tpu")
CACHE_DIR = ".portbench_cache"


def cache_environment(root: Path) -> None:
    """Every compiler cache the run may touch, at fixed paths inside the
    checkout; transformers-style libraries kept off JAX. Set before torch
    is imported."""
    cache = root / CACHE_DIR
    for var, sub in (
        ("TRITON_CACHE_DIR", "triton"),
        ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
        ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
        ("CUDA_CACHE_PATH", "cuda"),
    ):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> T.List[str]:
    """Top-level names of loaded modules that belong to JAX or to the JAX
    package, compared whole."""
    loaded = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(loaded & set(FORBIDDEN))


def load_json(path: Path) -> T.Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module of the benchmark found by its file name."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def power_limit() -> T.Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


@dataclasses.dataclass
class Check:
    """One number compared with the reference, and its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclasses.dataclass
class Context:
    """What a driver gets, and what it leaves for the metrics."""

    cell_name: str
    cell: T.Dict[str, T.Any]
    config: T.Dict[str, T.Any]
    seed: int
    seconds: float
    trace: bool
    device: T.Any
    root: Path
    workdir: Path
    start: float
    tracer: T.Any = None
    setup_s: T.Optional[float] = None
    counts: T.Any = None  # roofline.Counts of one unit of work
    units: int = 0  # steps, scenes' batches or calls in the window
    window_s: float = 0.0
    host_s: T.Dict[str, float] = dataclasses.field(default_factory=dict)
    metrics: T.Dict[str, float] = dataclasses.field(default_factory=dict)
    checks: T.List[Check] = dataclasses.field(default_factory=list)
    readings: T.Dict[str, float] = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    extra: T.Dict[str, T.Any] = dataclasses.field(default_factory=dict)

    @property
    def traffic(self) -> T.Dict[str, T.Any]:
        return self.cell["traffic_params"]

    @property
    def limits(self) -> T.Dict[str, float]:
        return self.cell["limits"]

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup_done(self) -> None:
        """Set-up and warm-up end here; the window starts next."""
        self.sync()
        self.setup_s = time.perf_counter() - self.start

    def read_peak_memory(self) -> None:
        import torch

        if self.device.type == "cuda":
            self.sync()
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated(self.device))

    def check(self, name: str, value: float) -> None:
        """Hold ``value`` to the cell's limit of that name; a number the
        cell sets no limit for is only printed."""
        if name in self.limits:
            self.checks.append(Check(name, float(value), float(self.limits[name])))
        else:
            self.readings[name] = float(value)


def parse_args(argv):
    parser = argparse.ArgumentParser(description="Run one benchmark cell.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def cell_metrics(bench: dict, cell_name: str, per_layer: bool) -> T.List[dict]:
    """The entries of ``end_to_end`` or ``per_layer`` that the cell
    reports: those that list it, or, without a list, those whose metric
    (or the one they move) the cell reports."""
    e2e = [
        m for m in bench["end_to_end"]
        if "workloads" not in m or cell_name in m["workloads"]
    ]
    if not per_layer:
        return e2e
    names = {m["name"] for m in e2e}
    return [
        m for m in bench["per_layer"]
        if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in names)
    ]


def fail(message: str) -> int:
    print(f"portbench: {message}", file=sys.stderr, flush=True)
    return 1


def main(argv=None, root: T.Optional[Path] = None, device: T.Optional[str] = None,
         start: T.Optional[float] = None) -> int:
    """Run one cell; ``device`` is for the CPU tests of the harness alone
    (a benchmark run always asks for the card)."""
    start = time.perf_counter() if start is None else start
    args = parse_args(argv)
    root = ROOT if root is None else Path(root)
    cache_environment(root)
    bench = load_json(root / "BENCHMARK.json")
    names = [w["name"] for w in bench["workloads"]]
    if args.workload not in names:
        return fail(f"unknown workload {args.workload!r}; BENCHMARK.json has {names}")
    entry = next(w for w in bench["workloads"] if w["name"] == args.workload)
    cell = load_json(root / "portbench" / "workloads" / f"{args.workload}.json")
    config_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = load_json(root / config_entry["file"])
    # A cell may fix the size of the host's intra-op thread pool, as the
    # deployment it stands for does; else torch's default.
    threads = cell.get("host_threads")
    if threads:
        os.environ["OMP_NUM_THREADS"] = str(threads)

    import torch

    if threads:
        torch.set_num_threads(int(threads))

    if device is None:
        if not torch.cuda.is_available():
            return fail("no CUDA card: torch.cuda.is_available() is False")
        if torch.cuda.device_count() < int(entry["chips"]):
            return fail(
                f"{args.workload} needs {entry['chips']} cards; "
                f"torch.cuda.device_count() is {torch.cuda.device_count()}"
            )
        device = "cuda:0"
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    from .trace import Tracer

    workdir = Path(tempfile.mkdtemp(prefix="portbench-"))
    trace_cfg = cell.get("trace", {"span": 3, "every": 10})
    ctx = Context(
        cell_name=args.workload, cell=cell, config=config, seed=args.seed,
        seconds=args.seconds, trace=bool(args.trace), device=dev, root=root,
        workdir=workdir, start=start,
        tracer=Tracer(bool(args.trace), trace_cfg["span"], trace_cfg["every"], dev),
    )
    driver = load_module(
        root / "portbench" / "drivers" / f"{cell['driver']}.py",
        f"portbench_driver_{cell['driver']}",
    )
    try:
        driver.run(ctx)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    out_metrics = {}
    for m in cell_metrics(bench, args.workload, per_layer=bool(args.trace)):
        if args.trace:
            module = load_module(
                root / "portbench" / "metrics" / f"{m['name']}.py",
                f"portbench_metric_{m['name'].replace('.', '_')}",
            )
            value = module.read(ctx)
        else:
            value = ctx.setup_s if m["name"] == "setup_s" else ctx.metrics.get(m["name"])
        if value is not None:
            out_metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": int(entry["chips"]),
        "memory_peak_bytes": ctx.memory_peak_bytes,
        "power_limit": power_limit() if dev.type == "cuda" else None,
    }
    result = {
        "correct": bool(ctx.checks) and all(c.ok for c in ctx.checks) and ctx.failed == 0,
        "attempted": ctx.attempted,
        "failed": ctx.failed,
        "metrics": out_metrics,
        "device": device_info,
    }
    if args.trace:
        device_info["busy_s"] = ctx.tracer.busy_s
        device_info["window_s"] = ctx.tracer.window_s
        result["breakdown"] = ctx.tracer.breakdown()
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in ctx.checks}
    for name, value in ctx.readings.items():
        print(f"reading {name} {value!r} (not compared)", file=sys.stderr)
    for c in ctx.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    # Last, once every metric has been read: nothing the run loaded may be
    # JAX or the JAX package.
    found = forbidden_modules()
    if found:
        return fail(f"JAX or the JAX package is loaded: {', '.join(found)}")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def quantile(values: T.Sequence[float], q: float) -> float:
    """The ``q`` quantile (0-100) of ``values`` by linear interpolation."""
    ordered = sorted(values)
    if len(ordered) == 1:
        return ordered[0]
    pos = (len(ordered) - 1) * q / 100.0
    low = int(pos)
    high = min(low + 1, len(ordered) - 1)
    return ordered[low] + (ordered[high] - ordered[low]) * (pos - low)

