#!/usr/bin/env python3
"""The card's idle time by program span on the three paths the port's
benchmark cells run, at their shapes, with seeded random weights and
inputs:

- ``train``: the CLI-default conv model's "16-mixed" train step over a
  split resident on the card (``make_hbm_train_step``, in-step dihedral
  augmentation, AdamW with the global-norm clip), batch 4 of 100^2 x T12;
- ``predict``: ``ScenePredictor.predict_scene`` with the transformer
  front end, bf16, batches of 8 windows of 100 px padded by 20, a 2,000^2
  scene;
- ``serve``: the conv model exported for the card in bf16 for batches of
  8 x 140^2 and called through ``load_predictor``'s ``ExportedPredictor``.

Each path warms up, then runs a few units under
``cultionet_tpu_torch/utils/profiling.py::profile_trace``, which writes
``trace.json`` and ``spans.json`` to ``OUT/<path>/`` (the traces take
tens of MB). Run from the root of a checkout on a machine with a CUDA
card:

    python3 span_profile.py [--out _measure/span_profile]

It prints one JSON line per path (per unit: wall ms, each span's self ms
and the card's idle ms under it; the root's self share; the largest gap
between a span and its ``cultionet.<name>`` event in the profile) and one
with the cost of a span off and on. ``--small`` runs tiny shapes on the
CPU, a rehearsal of the control flow.
"""

import argparse
import json
import time
import timeit
from pathlib import Path

import numpy as np
import torch

from cultionet_tpu_torch.export import export_state, load_predictor
from cultionet_tpu_torch.models import CultioNet
from cultionet_tpu_torch.predict import ScenePredictor
from cultionet_tpu_torch.train.optim import build_optimizer
from cultionet_tpu_torch.train.step import (
    create_train_state, make_hbm_train_step, make_train_step,
)
from cultionet_tpu_torch.utils import profiling

MODEL = dict(in_time=12, in_channels=3, hidden_channels=64, dropout=0.2,
             dilations=[1, 2], attention_weights="natten", activation_type="SiLU")
FULL = dict(chips=128, chip=100, batch=4, scene=2000, window=100, padding=20,
            predict_batch=8, serve_chip=140, serve_batch=8, device="cuda",
            train_units=5, scene_units=1, serve_units=20)
SMALL = dict(chips=8, chip=24, batch=2, scene=48, window=16, padding=4,
             predict_batch=4, serve_chip=24, serve_batch=2, device="cpu",
             train_units=2, scene_units=1, serve_units=3)


def model_kwargs(small: bool, encoder: str) -> dict:
    kwargs = dict(MODEL, temporal_encoder=encoder)
    if small:
        kwargs.update(hidden_channels=8, in_time=6)
    return kwargs


def wire(rng, shape) -> np.ndarray:
    return rng.integers(0, 10000, size=shape, dtype=np.int16)


def train_path(size, small, rng):
    device = torch.device(size["device"])
    kwargs = model_kwargs(small, "conv")
    t, n, s = kwargs["in_time"], size["chips"], size["chip"]
    arrays = {
        "x": torch.from_numpy(wire(rng, (n, t, s, s, 3))).to(device),
        "y": torch.from_numpy(rng.integers(0, 3, (n, s, s)).astype(np.int16)).to(device),
        "bdist": torch.from_numpy(wire(rng, (n, s, s))).to(device),
    }
    norm = (np.full(3, 0.5, np.float32), np.full(3, 0.29, np.float32))
    state = create_train_state(
        CultioNet(**kwargs),
        build_optimizer("AdamW", 0.01, 1e-3, 1e-4, gradient_clip_val=1.0),
        seed=0, device=device,
    )
    step = make_hbm_train_step(
        make_train_step(
            loss_name="TanimotoComplementLoss", precision="fp32" if small else "16-mixed",
            device=device, device_augment=True, norm_stats=norm,
        ),
        device=device,
    )
    generator = torch.Generator(device=device).manual_seed(0)

    def unit():
        indices = torch.randint(0, n, (size["batch"],), device=device, generator=generator)
        step(state, arrays, indices, generator)

    return unit, "train.step", size["train_units"]


def predict_path(size, small, rng):
    kwargs = model_kwargs(small, "transformer")
    predictor = ScenePredictor(
        CultioNet(**kwargs), batch_size=size["predict_batch"], precision="bf16",
        device=size["device"],
    )
    scene = wire(rng, (kwargs["in_time"], size["scene"], size["scene"], 3))
    window, padding = size["window"], size["padding"]
    corner = 3 * window
    predictor.predict_scene(scene[:, :corner, :corner], window_size=window, padding=padding)

    def unit():
        predictor.predict_scene(scene, window_size=window, padding=padding)

    return unit, "predict.scene", size["scene_units"]


def serve_path(size, small, rng, workdir):
    kwargs = model_kwargs(small, "conv")
    t, b, s = kwargs["in_time"], size["serve_batch"], size["serve_chip"]
    artifact = export_state(
        CultioNet(**kwargs), workdir / "serve.cnx", in_time=t, in_channels=3,
        batch_size=b, chip_size=s, precision="fp32" if small else "bf16",
        norm_mean=np.full(3, 0.5, np.float32), norm_std=np.full(3, 0.29, np.float32),
        device=size["device"],
    )
    predictor = load_predictor(artifact)
    pool = [wire(rng, (b, t, s, s, 3)) for _ in range(4)]
    lat = rng.uniform(-60, 60, b).astype(np.float32)
    lon = rng.uniform(-180, 180, b).astype(np.float32)
    calls = iter(range(1 << 30))

    def unit():
        predictor(pool[next(calls) % len(pool)], lat, lon)

    return unit, "serve.call", size["serve_units"]


def clock_gap_ms(prof, records) -> float:
    """The largest distance between a span's ends and those of its
    ``cultionet.<name>`` event in the profile."""
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(profiling.PREFIX) and "CUDA" not in str(e.device_type()):
            events.setdefault(e.name()[len(profiling.PREFIX):], []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    gap = 0
    for name in {r["name"] for r in records}:
        mine = sorted((r["start_ns"], r["end_ns"]) for r in records if r["name"] == name)
        theirs = sorted(events.get(name, []))
        if len(mine) != len(theirs):
            return float("inf")
        for (s0, e0), (s1, e1) in zip(mine, theirs):
            gap = max(gap, abs(s0 - s1), abs(e0 - e1))
    return gap / 1e6


def profile_path(name, unit, root, units, out: Path, device) -> dict:
    for _ in range(2):
        unit()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    profiling.reset()
    with profiling.profile_trace(out / name) as prof:
        start = time.perf_counter()
        for _ in range(units):
            unit()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - start
    summary = json.loads((out / name / "spans.json").read_text())
    spans = summary["spans"]
    count = spans[root]["count"]
    return {
        "path": name,
        "units": count,
        "wall_ms_per_unit": 1e3 * wall / count,
        "root_self_share": spans[root]["self_ms"] / spans[root]["total_ms"],
        "self_ms_per_unit": {n: s["self_ms"] / count for n, s in spans.items()},
        "idle_ms_per_unit": {n: s["idle_ms"] / count for n, s in spans.items()},
        "idle_between_spans_ms": summary["idle_between_spans_ms"],
        "counters_per_unit": {k: v / count for k, v in summary["counters"].items() if v},
        "clock_gap_ms": clock_gap_ms(prof, profiling.spans()),
    }


def span_cost(device) -> dict:
    """ns a span off (no profiler), and us a span on, under a profile of
    the host and the card."""
    n = 200_000
    off = timeit.timeit("with span('x'): pass", globals={"span": profiling.span}, number=n)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    m = 5_000
    with torch.profiler.profile(activities=activities):
        on = timeit.timeit("with span('x'): pass", globals={"span": profiling.span}, number=m)
    profiling.reset()
    return {"off_ns_per_span": 1e9 * off / n, "on_us_per_span": 1e6 * on / m}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default="_measure/span_profile")
    parser.add_argument("--small", action="store_true")
    args = parser.parse_args()
    size = SMALL if args.small else FULL
    device = torch.device(size["device"])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: torch.cuda.is_available() is False")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    print(json.dumps({
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "torch": torch.__version__,
    }), flush=True)
    for name, build in (
        ("train", lambda: train_path(size, args.small, rng)),
        ("predict", lambda: predict_path(size, args.small, rng)),
        ("serve", lambda: serve_path(size, args.small, rng, out)),
    ):
        unit, root, units = build()
        print(json.dumps(profile_path(name, unit, root, units, out, device)), flush=True)
        del unit
        if device.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps(span_cost(device)), flush=True)


if __name__ == "__main__":
    main()
