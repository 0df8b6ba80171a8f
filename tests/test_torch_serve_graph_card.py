"""The served program as a CUDA graph on the card
(``cultionet_tpu_torch/export.py::ExportedPredictor.call_on_device``), over
a conv and a transformer artifact of the CLI-default model (seeded weights,
BatchNorm statistics from three training passes) exported for the card in
bf16 at the serving batch of 8 x 12 x 140 x 140 x 3, with cuDNN's
deterministic algorithms on both sides.

- Two eager calls, the capture, three replays, each on new inputs: every
  call's outputs equal, within 1e-6, those of the artifact's program as
  ``torch.export.load`` gives it, run eagerly (its host constants on the
  host, where the predictor moves them to the card); calls on other inputs
  give other outputs, and a caller's outputs keep their values after the
  later calls.
- Every call, replays too, advances the launch tables by one call's
  launches (``na2d_fwd`` 3; and ``temporal_fwd`` 3, ``layer_norm_rows`` 7
  for the transformer); ``graph_replays`` rises by 1 a call from the
  capture on, ``graph_captures`` by 1 in all.
- A call under other backend settings warms up again: it runs eagerly.
- Two threads that share a predictor and call ``pred(x, lat, lon)``
  from its first call on, through the warm-ups and the capture, raise
  nothing and each get the program's outputs; the calls count one capture
  and a replay each after the warm-ups.
- A replayed ``pred(x, lat, lon)`` under ``torch.profiler`` lists
  ``na2d_fwd``; its root span ``serve.call`` counts one replay, six
  blocking copies and one call's launches.

Needs a CUDA card; skipped without one. This file imports neither JAX nor
the JAX package, so it runs on a machine without them:
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_serve_graph_card.py``.
"""

import io
import threading
import zipfile

import numpy as np
import pytest
import torch

from cultionet_tpu_torch.export import WARMUP, export_state, load_predictor
from cultionet_tpu_torch.models import CultioNet
from cultionet_tpu_torch.nn.dropout import dropout_rng
from cultionet_tpu_torch.nn.init import init_parameters_
from cultionet_tpu_torch.ops import flags
from cultionet_tpu_torch.utils import profiling

BATCH, TIME, SIDE, BANDS = 8, 12, 140, 3
CALLS = WARMUP + 4  # the warm-ups, the capture and three replays
ENCODERS = ["conv", "transformer"]
LAUNCHES = {
    "conv": {"na2d_fwd": 3},
    "transformer": {"na2d_fwd": 3, "temporal_fwd": 3, "layer_norm_rows": 7},
}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run these tests on a machine with one")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda:0")
    torch.backends.cudnn.deterministic = deterministic


@pytest.fixture(scope="module")
def artifacts(card, tmp_path_factory):
    out = {}
    for encoder in ENCODERS:
        model = CultioNet(
            in_time=TIME, in_channels=BANDS, hidden_channels=64,
            dilations=[1, 2], dropout=0.2, activation_type="SiLU",
            attention_weights="natten", temporal_encoder=encoder,
        )
        init_parameters_(model, torch.Generator().manual_seed(0))
        model.to(card).train()
        gen = torch.Generator(device=card).manual_seed(7)
        with torch.no_grad(), dropout_rng(gen):
            for _ in range(3):
                model(torch.rand(BATCH, TIME, SIDE, SIDE, BANDS, device=card,
                                 generator=gen))
        out[encoder] = export_state(
            model.eval(), tmp_path_factory.mktemp("serve") / f"{encoder}.cnx",
            in_time=TIME, in_channels=BANDS, batch_size=BATCH, chip_size=SIDE,
            precision="bf16", norm_mean=np.array([0.4, 0.5, 0.45], np.float32),
            norm_std=np.array([0.2, 0.25, 0.3], np.float32),
        )
    return out


def eager_program(path):
    """The artifact's program as ``torch.export.load`` gives it, run
    eagerly."""
    with zipfile.ZipFile(path) as zf:
        return torch.export.load(io.BytesIO(zf.read("program.pt2"))).module()


def wire(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 10000, size=(BATCH, TIME, SIDE, SIDE, BANDS), dtype=np.int16)
    lat = rng.uniform(-60, 60, size=BATCH).astype(np.float32)
    lon = rng.uniform(-180, 180, size=BATCH).astype(np.float32)
    return x, lat, lon


def on_card(x, lat, lon, card):
    return tuple(torch.from_numpy(v).to(card) for v in (x, lat, lon))


def launch_counts():
    return {name: n for table in flags.launch_tables() for name, n in table.items()}


def launched(before):
    return {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}


@pytest.mark.card
@pytest.mark.parametrize("encoder", ENCODERS)
def test_replays_follow_the_eager_module(card, artifacts, encoder):
    pred = load_predictor(artifacts[encoder])
    batches = [on_card(*wire(seed), card) for seed in range(CALLS)]
    captures0 = profiling.COUNTS["graph_captures"]
    results = []
    for i, inputs in enumerate(batches):
        before, replays = launch_counts(), profiling.COUNTS["graph_replays"]
        outs = pred.call_on_device(*inputs)
        assert launched(before) == LAUNCHES[encoder], i
        assert profiling.COUNTS["graph_replays"] - replays == int(i >= WARMUP), i
        results.append((outs, [out.clone() for out in outs]))
    assert profiling.COUNTS["graph_captures"] - captures0 == 1

    loaded = eager_program(artifacts[encoder])
    for i, ((outs, copies), inputs) in enumerate(zip(results, batches)):
        with torch.inference_mode():
            want = loaded(*inputs)
        for got, kept, w in zip(outs, copies, want):
            # A caller's outputs keep their values after the later calls.
            assert torch.equal(got, kept), i
            assert got.dtype == w.dtype == torch.float32 and got.shape == w.shape
            gap = float((got - w).abs().max())
            assert gap <= 1e-6, (i, gap)
    # Other inputs, other outputs: the static inputs are refreshed.
    for (a, _), (b, _) in zip(results, results[1:]):
        assert all(not torch.equal(u, v) for u, v in zip(a, b))

    # Other backend settings: the graph goes, and the call runs eagerly.
    torch.backends.cudnn.deterministic = False
    try:
        before, replays = launch_counts(), profiling.COUNTS["graph_replays"]
        pred.call_on_device(*batches[0])
        assert launched(before) == LAUNCHES[encoder]
        assert profiling.COUNTS["graph_replays"] == replays
    finally:
        torch.backends.cudnn.deterministic = True


@pytest.mark.card
def test_threads_share_a_predictor_through_the_capture(card, artifacts):
    pred = load_predictor(artifacts["conv"])
    batches = [wire(seed) for seed in (20, 21)]
    loaded = eager_program(artifacts["conv"])
    with torch.inference_mode():
        wants = [[w.cpu().numpy() for w in loaded(*on_card(*b, card))] for b in batches]
    captures, replays = (profiling.COUNTS[k] for k in ("graph_captures", "graph_replays"))
    results, errors = ([], []), []
    start = threading.Barrier(len(batches))

    def caller(i):
        try:
            start.wait()
            for _ in range(CALLS):
                results[i].append(pred(*batches[i]))
        except BaseException as err:  # noqa: BLE001  (reported below)
            errors.append(err)

    threads = [threading.Thread(target=caller, args=(i,)) for i in range(len(batches))]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    assert errors == []
    assert profiling.COUNTS["graph_captures"] - captures == 1
    assert profiling.COUNTS["graph_replays"] - replays == len(batches) * CALLS - WARMUP
    for outs, want in zip(results, wants):
        assert len(outs) == CALLS
        for j, out in enumerate(outs):
            for name, w in zip(pred.meta["outputs"], want):
                gap = float(np.abs(out[name] - w).max())
                assert gap <= 1e-6, (j, name, gap)


@pytest.mark.card
@pytest.mark.parametrize("encoder", ENCODERS)
def test_profiled_replay_lists_na_and_counts_one_replay(card, artifacts, encoder):
    pred = load_predictor(artifacts[encoder])
    for seed in range(WARMUP + 1):  # the capture is the last
        pred(*wire(seed))
    torch.cuda.synchronize()
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        pred(*wire(10))
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    kernels = [e.name() for e in events if "CUDA" in str(e.device_type())]
    assert any("na2d_fwd" in k for k in kernels)
    call = profiling.totals()["serve.call"]
    assert call["count"] == 1
    counts = {k: v for k, v in call["counts"].items() if v}
    assert counts.pop("graph_replays") == 1
    assert counts.pop("blocking_copies") == 6
    assert counts.pop("h2d_bytes") > 0 and counts.pop("d2h_bytes") > 0
    assert counts == LAUNCHES[encoder]
