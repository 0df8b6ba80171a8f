"""The port's tracing (``cultionet_tpu_torch/utils/profiling.py``) on the
CPU, over the three paths it instruments at a tiny size: the train step
(plain and over a resident split), ``ScenePredictor.predict_scene`` and
an exported artifact's served call.

- With no profiler a unit records no span and enters no
  ``record_function``; under ``torch.profiler`` each records its root and
  the children named in the module, under one request id, each span
  within 1 ms of its ``cultionet.<name>`` event in the profile (one
  clock).
- ``totals()`` self time of nested spans; the record cap drops and
  counts, the totals stay exact; ``COUNTS`` equal the bytes and copies of
  a served call and of a scene; a traced train step equals an untraced
  one bit for bit; ``idle_by_span`` gives each device gap to the
  innermost span; ``profile_trace`` writes ``spans.json`` beside
  ``trace.json``; ``span_profile.py --small`` runs.
"""

import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cultionet_tpu_torch.data.batch import Batch
from cultionet_tpu_torch.export import export_state, load_predictor
from cultionet_tpu_torch.models import CultioNet
from cultionet_tpu_torch.predict import ScenePredictor
from cultionet_tpu_torch.train import optim as torch_optim
from cultionet_tpu_torch.train import step as torch_step
from cultionet_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
IN_TIME = 5
CHIP = 16
MODEL = dict(in_time=IN_TIME, hidden_channels=4, dilations=[1, 2],
             attention_weights="natten")
NORM = (np.array([0.4, 0.5, 0.6], np.float32), np.array([0.2, 0.3, 0.25], np.float32))
WINDOW, PADDING, SCENE = 8, 4, 24  # 9 windows of 16 px: batches of 2, 2, 2, 2, 1
PATHS = ["train", "hbm", "predict", "serve"]
ROOTS = {"train": "train.step", "hbm": "train.step", "predict": "predict.scene",
         "serve": "serve.call"}
TRAIN_CHILDREN = {"train.prepare": 1, "train.forward": 1, "train.backward": 1,
                  "train.optimizer": 1}
CHILDREN = {
    "train": TRAIN_CHILDREN,
    "hbm": dict(TRAIN_CHILDREN, **{"train.gather": 1}),
    "predict": {"predict.cut": 5, "predict.copy": 5, "predict.forward": 5,
                "predict.blend": 5, "predict.readback": 1},
    "serve": {"serve.copy": 1, "serve.program": 1, "serve.readback": 1},
}


@pytest.fixture(autouse=True)
def clean_recorder():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.enabled(False)
    profiling.reset()
    yield
    profiling.enabled(False)
    profiling.reset()
    torch.set_num_threads(threads)


def wire(seed, shape):
    return np.random.default_rng(seed).integers(0, 10000, size=shape, dtype=np.int16)


def train_state(seed=0):
    torch.manual_seed(seed)
    return torch_step.create_train_state(
        CultioNet(dropout=0.2, **MODEL), torch_optim.build_optimizer("AdamW", 1e-3),
        device="cpu",
    )


def host_batch(seed=1):
    rng = np.random.default_rng(seed)
    return Batch(
        x=torch.from_numpy(wire(seed, (2, IN_TIME, CHIP, CHIP, 3))),
        y=torch.from_numpy(rng.integers(0, 3, size=(2, CHIP, CHIP)).astype(np.int16)),
        bdist=torch.from_numpy(wire(seed + 1, (2, CHIP, CHIP))),
    )


def train_kwargs():
    return dict(loss_name="TanimotoComplementLoss", device_augment=True,
                norm_stats=NORM, device="cpu")


@pytest.fixture(scope="module")
def units(tmp_path_factory):
    """One unit of work of each path, as a callable."""
    state = train_state()
    step = torch_step.make_train_step(**train_kwargs())
    hbm_step = torch_step.make_hbm_train_step(step, device="cpu")
    batch = host_batch()
    resident = host_batch(seed=3)
    arrays = {"x": resident.x, "y": resident.y, "bdist": resident.bdist}
    generator = torch.Generator().manual_seed(5)

    model = CultioNet(**MODEL)
    predictor = ScenePredictor(model, batch_size=2, precision="fp32", device="cpu")
    scene = wire(7, (IN_TIME, SCENE, SCENE, 3))
    artifact = export_state(
        model, tmp_path_factory.mktemp("serve") / "a.cnx", in_time=IN_TIME,
        in_channels=3, batch_size=2, chip_size=CHIP, precision="fp32", device="cpu",
    )
    served = load_predictor(artifact)
    x = wire(8, (2, IN_TIME, CHIP, CHIP, 3))
    lat = np.array([45.0, 46.0], np.float32)
    lon = np.array([-120.0, -119.0], np.float32)
    return {
        "train": lambda: step(state, batch, generator),
        "hbm": lambda: hbm_step(state, arrays, torch.tensor([0, 1]), generator),
        "predict": lambda: predictor.predict_scene(scene, window_size=WINDOW, padding=PADDING),
        "serve": lambda: served(x, lat, lon),
        "served_inputs": (x, lat, lon),
    }


def profiled(fn, times=2):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        results = [fn() for _ in range(times)]
    return prof, results


@pytest.mark.parametrize("path", PATHS)
def test_off_records_nothing_and_enters_no_range(units, path, monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    units[path]()
    assert not [n for n in entered if n.startswith(profiling.PREFIX)]
    assert profiling.spans() == [] and profiling.totals() == {}
    # The stub sees the program's ranges once tracing is on.
    profiling.enabled(True)
    units[path]()
    assert profiling.PREFIX + ROOTS[path] in entered


@pytest.mark.parametrize("path", PATHS)
def test_profiled_unit_records_root_and_children(units, path):
    profiled(units[path])
    records = profiling.spans()
    roots = [r for r in records if r["parent"] is None]
    assert [r["name"] for r in roots] == [ROOTS[path]] * 2
    assert len({r["request"] for r in roots}) == 2
    for root in roots:
        inside = [r for r in records if r["request"] == root["request"] and r is not root]
        assert all(r["parent"] == root["id"] for r in inside)
        names = {}
        for r in inside:
            names[r["name"]] = names.get(r["name"], 0) + 1
            assert root["start_ns"] <= r["start_ns"] <= r["end_ns"] <= root["end_ns"]
        assert names == CHILDREN[path]
        assert set(root["counts"]) == set(profiling.COUNTS)
    totals = profiling.totals()
    assert totals[ROOTS[path]]["count"] == 2
    assert {n: totals[n]["count"] for n in CHILDREN[path]} == {
        n: 2 * c for n, c in CHILDREN[path].items()
    }


@pytest.mark.parametrize("path", PATHS)
def test_spans_share_the_profilers_clock(units, path):
    prof, _ = profiled(units[path])
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(profiling.PREFIX):
            events.setdefault(e.name()[len(profiling.PREFIX):], []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns())
            )
    records = profiling.spans()
    assert records
    for name in {r["name"] for r in records}:
        mine = sorted((r["start_ns"], r["end_ns"]) for r in records if r["name"] == name)
        theirs = sorted(events[name])
        assert len(mine) == len(theirs)
        for (s0, e0), (s1, e1) in zip(mine, theirs):
            assert abs(s0 - s1) < 1_000_000 and abs(e0 - e1) < 1_000_000, name


class FakeClock:
    """``time.time_ns`` moving 10 ns at each read."""

    def __init__(self):
        self.now = 0

    def time_ns(self):
        self.now += 10
        return self.now


def test_totals_self_time_of_nested_spans(monkeypatch):
    monkeypatch.setattr(profiling, "time", FakeClock())
    profiling.enabled(True)
    with profiling.span("outer"):
        with profiling.span("inner"):
            with profiling.span("leaf"):
                pass
        with profiling.span("inner"):
            pass
    with profiling.span("outer"):
        pass
    records = {r["id"]: r for r in profiling.spans()}
    totals = profiling.totals()
    assert {n: t["count"] for n, t in totals.items()} == {"outer": 2, "inner": 2, "leaf": 1}
    for name, t in totals.items():
        mine = [r for r in records.values() if r["name"] == name]
        assert t["total_ns"] == sum(r["end_ns"] - r["start_ns"] for r in mine)
        children = [r for r in records.values() if records.get(r["parent"], {}).get("name") == name]
        assert t["self_ns"] == t["total_ns"] - sum(r["end_ns"] - r["start_ns"] for r in children)
    # Each span reads the clock twice: leaf 10 ns, the inner spans 30 and
    # 10, the first outer 70 of which 40 in its children, the second 10.
    assert (totals["leaf"]["self_ns"], totals["inner"]["self_ns"],
            totals["outer"]["self_ns"]) == (10, 30, 40)
    first, second = sorted({r["request"] for r in records.values()})
    assert [r["name"] for r in records.values() if r["request"] == second] == ["outer"]


def test_join_adds_no_second_span_of_the_same_name():
    profiling.enabled(True)
    with profiling.span("train.step"):
        with profiling.span("train.step", join=True):
            with profiling.span("train.forward"):
                pass
    with profiling.span("train.step", join=True):
        pass
    names = [r["name"] for r in profiling.spans()]
    assert names == ["train.forward", "train.step", "train.step"]
    forward, first, _ = profiling.spans()
    assert forward["parent"] == first["id"]


def test_cap_drops_and_counts_and_totals_stay_exact(monkeypatch):
    monkeypatch.setattr(profiling, "time", FakeClock())
    monkeypatch.setattr(profiling, "MAX_RECORDS", 5)
    profiling.enabled(True)
    for _ in range(4):
        with profiling.span("root"):
            with profiling.span("child"):
                pass
    assert len(profiling.spans()) == 5 and profiling.dropped() == 3
    totals = profiling.totals()
    assert totals["child"] == {"count": 4, "total_ns": 40, "self_ns": 40, "counts": {}}
    assert {k: totals["root"][k] for k in ("count", "total_ns", "self_ns")} == {
        "count": 4, "total_ns": 120, "self_ns": 80,
    }
    profiling.reset()
    assert profiling.spans() == [] and profiling.dropped() == 0 and profiling.totals() == {}


def test_cpu_paths_copy_nothing(units):
    before = dict(profiling.COUNTS)
    units["serve"]()
    units["predict"]()
    assert profiling.COUNTS == before


@pytest.mark.parametrize("path", ["serve", "predict"])
def test_counts_equal_the_copies_a_unit_makes(units, path, monkeypatch):
    """With every copy taken as one between host and card (the CPU has no
    card), the counters see each copy the unit asks for."""
    monkeypatch.setattr(profiling, "_crosses", lambda src, dst: True)
    before = dict(profiling.COUNTS)
    with profile(activities=[ProfilerActivity.CPU]):
        out = units[path]()
    moved = {k: v - before[k] for k, v in profiling.COUNTS.items()}
    # No CUDA graph runs on these paths, no dated (U-TAE) batch, and no
    # LayerNorm kernel on the CPU.
    want = {"graph_captures": 0, "graph_replays": 0,
            "utae_date_images": 0, "utae_pad_images": 0,
            "layernorm_kernels": 0}
    if path == "serve":
        x, lat, lon = units["served_inputs"]
        want.update({"h2d_bytes": x.nbytes + lat.nbytes + lon.nbytes,
                     "d2h_bytes": sum(v.nbytes for v in out.values()),
                     "blocking_copies": 6})
    else:
        # 5 batches of x (int16 windows of 16 px), lat and lon (float32),
        # and the raster's read-back.
        windows = 9 * IN_TIME * CHIP * CHIP * 3 * 2
        want.update({"h2d_bytes": windows + 2 * 9 * 4,
                     "d2h_bytes": out[0].nbytes, "blocking_copies": 16})
    assert moved == want
    assert profiling.totals()[ROOTS[path]]["counts"] == want


@pytest.mark.parametrize("traced", ["enabled", "profiler"])
def test_traced_train_step_equals_untraced(traced):
    results = []
    for on in (False, True):
        state = train_state(seed=11)
        step = torch_step.make_hbm_train_step(
            torch_step.make_train_step(**train_kwargs()), device="cpu"
        )
        resident = host_batch(seed=12)
        arrays = {"x": resident.x, "y": resident.y, "bdist": resident.bdist}
        generator = torch.Generator().manual_seed(13)

        def two_steps():
            return [step(state, arrays, torch.tensor([1, 0]), generator)[1]["loss"]
                    for _ in range(2)]

        if on and traced == "profiler":
            _, (losses,) = profiled(two_steps, times=1)
        else:
            profiling.enabled(on)
            losses = two_steps()
            profiling.enabled(False)
        results.append((losses, {n: p.detach().clone() for n, p in state.model.named_parameters()}))
    assert profiling.totals()["train.step"]["count"] == 2
    (loss_off, params_off), (loss_on, params_on) = results
    assert all(torch.equal(a, b) for a, b in zip(loss_off, loss_on))
    assert all(torch.equal(params_off[n], params_on[n]) for n in params_off)


def fake_event(name, start, end, device):
    return types.SimpleNamespace(
        name=lambda: name, start_ns=lambda: start, duration_ns=lambda: end - start,
        device_type=lambda: f"DeviceType.{device}",
    )


def test_idle_by_span_gives_each_gap_to_the_innermost_span():
    events = [
        fake_event("cultionet.serve.call", 0, 1000, "CPU"),
        fake_event("cultionet.serve.copy", 0, 200, "CPU"),
        fake_event("cultionet.serve.program", 200, 900, "CPU"),
        fake_event("aten::add", 300, 310, "CPU"),
        # The host range mirrored on the device timeline: not device work.
        fake_event("cultionet.serve.program", 250, 950, "CUDA"),
        fake_event("Memcpy HtoD", 100, 150, "CUDA"),
        fake_event("kernel_a", 300, 400, "CUDA"),
        fake_event("kernel_b", 350, 500, "CUDA"),  # overlaps a: one interval
        fake_event("kernel_c", 800, 850, "CUDA"),
        fake_event("kernel_d", 1100, 1200, "CUDA"),
    ]
    prof = types.SimpleNamespace(
        profiler=types.SimpleNamespace(
            kineto_results=types.SimpleNamespace(events=lambda: events)
        )
    )
    # Gaps: 150-300 (middle 225, in program), 500-800 (program), 850-1100
    # (middle 975, in call only).
    assert profiling.idle_by_span(prof) == {
        "serve.program": 150 + 300, "serve.call": 250,
    }
    events.append(fake_event("kernel_e", 1500, 1600, "CUDA"))
    assert profiling.idle_by_span(prof)["between spans"] == 300


def test_profile_trace_writes_spans_and_trace(tmp_path, units):
    units["serve"]()  # untraced: not in the summary
    with profiling.profile_trace(tmp_path / "prof"):
        units["serve"]()
        units["serve"]()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    summary = json.loads((tmp_path / "prof" / "spans.json").read_text())
    assert set(summary["spans"]) == {"serve.call", "serve.copy", "serve.program", "serve.readback"}
    call = summary["spans"]["serve.call"]
    assert call["count"] == 2 and 0 <= call["self_ms"] <= call["total_ms"]
    assert set(call) == {"count", "total_ms", "self_ms", "idle_ms"}
    assert summary["dropped"] == 0 and summary["counters"]["blocking_copies"] == 0


def test_span_profile_script_runs_its_rehearsal(tmp_path):
    """``span_profile.py --small``: the three paths at a CPU size, one
    line each with the root's self share and every span's self ms."""
    out = subprocess.run(
        [sys.executable, "span_profile.py", "--small", "--out", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    paths = {line["path"]: line for line in lines if "path" in line}
    assert set(paths) == {"train", "predict", "serve"}
    for name, line in paths.items():
        assert 0 <= line["root_self_share"] < 1 and line["clock_gap_ms"] < 1, name
        assert (tmp_path / name / "spans.json").is_file()
    assert set(paths["serve"]["self_ms_per_unit"]) == {
        "serve.call", "serve.copy", "serve.program", "serve.readback"}
    assert lines[-1]["on_us_per_span"] > 0 and lines[-1]["off_ns_per_span"] > 0
