"""The port's serving export (``cultionet_tpu_torch/export.py``) on the CPU:
the artifact against the JAX package's StableHLO artifact on the same
weights, and the counterpart of each case of ``tests/test_export.py``
that concerns the artifact itself (the log transform and the
``export_predictor`` gates are in ``test_torch_export_gates.py``). Also:
a JAX artifact refused by the port's loader, the registered attention
ops in the exported graph, their fake and real implementations agreeing
(``torch.library.opcheck``), a fresh process that loads and calls an
artifact without importing the port's model code, and the served CUDA
graph's rule on the CPU: a CPU artifact never captures, the engagement
rule keeps every call it cannot replay eager, and the plan warms up,
captures, replays and starts over under another key (the graph itself
runs only on a card: ``tests/test_torch_serve_graph_card.py``).

Tiny model: in_time 5, hidden 4, natten, dilations [1, 2], 16 x 16 chips,
batch 2, fp32. An export takes about 5 s on the CPU.
"""

import json
import subprocess
import sys
import textwrap
import zipfile
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cultionet_tpu.data.batch import Batch as JaxBatch
from cultionet_tpu.export import export_state as jax_export_state
from cultionet_tpu.export import load_predictor as jax_load_predictor
from cultionet_tpu.models import CultioNet as JaxCultioNet
from cultionet_tpu.train import step as jax_step
from cultionet_tpu_torch import export as export_module
from cultionet_tpu_torch.export import (
    CLIP_MAX,
    CLIP_MIN,
    SERVE_ABI_VERSION,
    build_serve_fn,
    eager_reason,
    export_state,
    load_predictor,
)
from cultionet_tpu_torch.models import CultioNet
from cultionet_tpu_torch.ops.natten import na2d_inference
from cultionet_tpu_torch.ops.temporal import temporal_inference
from cultionet_tpu_torch.utils import profiling
from cultionet_tpu_torch.utils.params import load_flax

from torch_port_helpers import (
    jax_transformer_model,
    port_transformer_model,
    seeded_variables,
)

NORM_MEAN = np.array([0.1, 0.2, 0.3], np.float32)
NORM_STD = np.array([1.1, 0.9, 1.2], np.float32)
IN_TIME = 5
X_SHAPE = (2, IN_TIME, 16, 16, 3)
LAT = np.array([45.0, 46.0], np.float32)
LON = np.array([-120.0, -119.0], np.float32)
MODEL = dict(
    in_time=IN_TIME, hidden_channels=4, attention_weights="natten",
    dilations=[1, 2],
)
REPO = Path(__file__).resolve().parents[1]


def _export(model, out, **kwargs):
    return export_state(
        model, out, in_time=IN_TIME, in_channels=3, batch_size=2,
        chip_size=16, precision="fp32", device="cpu", **kwargs,
    )


def _wire(seed):
    return np.random.default_rng(seed).integers(
        0, 10000, size=X_SHAPE, dtype=np.int16
    )


@pytest.fixture(scope="module")
def weights():
    """Seeded JAX variables of the tiny model and the port's model holding
    them."""
    jax_model = JaxCultioNet(**MODEL)
    variables = seeded_variables(
        jax_model, JaxBatch(x=jnp.zeros((1, IN_TIME, 16, 16, 3))),
        training=False, seed=5,
    )
    return jax_model, variables, load_flax(CultioNet(**MODEL), variables)


@pytest.fixture(scope="module")
def artifact(weights, tmp_path_factory):
    return _export(
        weights[2], tmp_path_factory.mktemp("serve") / "model.cnx",
        norm_mean=NORM_MEAN, norm_std=NORM_STD,
        extra_meta={"hyperparams": {"hidden_channels": 4}},
    )


def test_artifact_matches_jax_artifact(weights, artifact, tmp_path):
    """The port's CPU artifact and JAX's (``platforms=["cpu"]``) on the same
    weights and wire batch: rasters within 1e-4."""
    jax_model, variables, _ = weights
    state = jax_step.TrainState.create(
        apply_fn=jax_model.apply, params=variables["params"],
        batch_stats=variables["batch_stats"], tx=optax.sgd(0.0),
    )
    jax_artifact = jax_export_state(
        state, tmp_path / "jax.cnx", in_time=IN_TIME, in_channels=3,
        batch_size=2, chip_size=16, precision="fp32", norm_mean=NORM_MEAN,
        norm_std=NORM_STD, platforms=["cpu"],
    )
    x = _wire(6)
    want = jax_load_predictor(jax_artifact)(x, LAT, LON)
    got = load_predictor(artifact)(x, LAT, LON)
    assert set(got) == set(want) == {"distance", "edge", "crop"}
    for name in want:
        assert got[name].shape == want[name].shape
        np.testing.assert_allclose(got[name], want[name], atol=1e-4, err_msg=name)

    # A JAX artifact is refused by the port's loader, by name.
    with pytest.raises(ValueError, match="not a torch.export serving artifact"):
        load_predictor(jax_artifact)


def test_artifact_structure(artifact):
    with zipfile.ZipFile(artifact) as zf:
        assert {"program.pt2", "meta.json"} <= set(zf.namelist())
        meta = json.loads(zf.read("meta.json").decode())
    assert meta["abi_version"] == SERVE_ABI_VERSION
    assert meta["inputs"]["x"]["shape"] == list(X_SHAPE)
    assert meta["inputs"]["x"]["dtype"] == "int16"
    assert meta["inputs"]["x"]["clip"] == [CLIP_MIN, CLIP_MAX]
    assert meta["outputs"] == ["distance", "edge", "crop"]
    assert meta["normalized"] is True
    assert meta["log_transform"] is False
    assert meta["platforms"] == ["cpu"]
    assert meta["kernels"] == "plain"  # a CPU program: the plain versions
    assert meta["ops"] == {"cultionet_tpu_torch::na2d": 3}
    assert meta["torch_version"] == torch.__version__
    assert "required" in meta["coords"]
    assert meta["hyperparams"]["hidden_channels"] == 4


def test_roundtrip_matches_direct_path(weights, artifact):
    """The loaded program equals the eager serve module, and the eager
    serve module equals the dataset pipeline (clip, z-score) followed by the
    model's eval forward."""
    model = weights[2]
    x = _wire(1)
    out = load_predictor(artifact)(x, LAT, LON)
    for val in out.values():
        assert val.dtype == np.float32
        assert val.shape[:3] == (2, 16, 16) and np.isfinite(val).all()

    serve = build_serve_fn(model, NORM_MEAN, NORM_STD, precision="fp32")
    with torch.no_grad():
        direct = serve(torch.from_numpy(x), torch.from_numpy(LAT),
                       torch.from_numpy(LON))
        vals = np.clip(x.astype(np.float32) / 10000.0, CLIP_MIN, CLIP_MAX)
        model_out = model.eval()(torch.from_numpy((vals - NORM_MEAN) / NORM_STD))
    for name, d in zip(("distance", "edge", "crop"), direct):
        np.testing.assert_allclose(out[name], d.numpy(), atol=1e-5)
        np.testing.assert_allclose(
            d.numpy(), model_out[name].numpy(), atol=1e-5
        )


def test_clip_sanitizes_wire_input(artifact):
    """Negative nodata sentinels and values above 10000 are clipped as the
    dataset pipeline clips them."""
    x = _wire(3)
    x_bad, x_ref = x.copy(), x.copy()
    x_bad[0, 0, :4, :4, 0] = -5000
    x_bad[1, 1, :4, :4, 1] = 20000
    x_ref[0, 0, :4, :4, 0] = 0
    x_ref[1, 1, :4, :4, 1] = 10000
    pred = load_predictor(artifact)
    out_bad, out_ref = pred(x_bad, LAT, LON), pred(x_ref, LAT, LON)
    for name in out_bad:
        np.testing.assert_allclose(out_bad[name], out_ref[name], atol=1e-6)


def test_coords_required(artifact):
    pred = load_predictor(artifact)
    with pytest.raises(ValueError, match="lat/lon"):
        pred(_wire(2))
    assert np.isfinite(pred(_wire(2), fill_coords=True)["crop"]).all()


def test_abi_version_gate(artifact, tmp_path):
    bad = tmp_path / "bad.cnx"
    with zipfile.ZipFile(artifact) as src, zipfile.ZipFile(bad, "w") as dst:
        meta = json.loads(src.read("meta.json").decode())
        meta["abi_version"] = SERVE_ABI_VERSION + 1
        dst.writestr("program.pt2", src.read("program.pt2"))
        dst.writestr("meta.json", json.dumps(meta))
    with pytest.raises(ValueError, match="ABI"):
        load_predictor(bad)


def test_transformer_graph_names_both_ops(tmp_path):
    """The transformer front end's artifact calls the temporal op 3 times
    (two layers and the pooling), the NA op 3 times and the LayerNorm op 7
    times (two per layer, the pooling keys and query, the embedding), and
    equals JAX's eval forward on the same weights through the dataset
    pipeline."""
    import jax

    jax_model, variables = jax_transformer_model(4, in_time=IN_TIME, size=16)
    model = load_flax(port_transformer_model(4, in_time=IN_TIME), variables)
    pred = load_predictor(_export(model, tmp_path / "t.cnx"))
    assert pred.meta["ops"] == {
        "cultionet_tpu_torch::temporal_attention": 3,
        "cultionet_tpu_torch::na2d": 3,
        "cultionet_tpu_torch::layer_norm_rows": 7,
    }
    code = str(pred.program.graph_module.code)
    assert "cultionet_tpu_torch.na2d" in code
    assert "cultionet_tpu_torch.temporal_attention" in code
    assert "cultionet_tpu_torch.layer_norm_rows" in code
    x = _wire(7)
    got = pred(x, LAT, LON)
    vals = np.clip(x.astype(np.float32) / 10000.0, CLIP_MIN, CLIP_MAX)
    want = jax.jit(lambda v, x: jax_model.apply(v, JaxBatch(x=x), training=False))(
        variables, jnp.asarray(vals)
    )
    for name in got:
        np.testing.assert_allclose(
            got[name], np.asarray(want[name]), atol=1e-4, err_msg=name
        )


def test_load_imports_no_model_code(artifact):
    """A fresh process loads and calls the artifact with ``load_predictor``
    alone: no module of ``cultionet_tpu_torch.models`` or ``.nn``, and no
    JAX, is imported."""
    script = textwrap.dedent(
        f"""
        import sys
        import numpy as np
        from cultionet_tpu_torch.export import load_predictor
        pred = load_predictor({str(artifact)!r})
        out = pred(np.zeros({X_SHAPE}, np.int16), fill_coords=True)
        assert out["crop"].shape == (2, 16, 16, 1), out["crop"].shape
        bad = [m for m in sys.modules if m.startswith(
            ("cultionet_tpu_torch.models", "cultionet_tpu_torch.nn", "jax",
             "cultionet_tpu."))]
        assert not bad, bad
        print("ok")
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_ops_fake_and_real_agree():
    """``torch.library.opcheck`` on the CPU: schema, fake implementation and
    the real one agree, on the strided views the model passes (thirds of a
    fused projection; the pooling query broadcast along the pixels)."""
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn(2, 12, 10, 3 * 8, generator=gen)
    q, k, v = (t.unflatten(-1, (2, 4)) for t in qkv.chunk(3, -1))
    torch.library.opcheck(na2d_inference, (q, k, v, 3, 2))
    tokens = torch.randn(50, 6, 3 * 8, generator=gen)
    q, k, v = tokens.chunk(3, -1)
    torch.library.opcheck(temporal_inference, (q, k, v, 2))
    query = torch.randn(1, 1, 8, generator=gen).expand(50, 1, 8)
    torch.library.opcheck(temporal_inference, (query, k, v, 2))


def test_card_export_refuses_plain_versions(weights, monkeypatch, tmp_path):
    """A card program must call the kernels: with ``set_cuda_natten(False)``
    in force the export raises before tracing (the flag check runs before
    anything touches the card, so it shows here)."""
    from cultionet_tpu_torch.ops import flags

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(flags, "_USE_CUDA_NATTEN", False)
    with pytest.raises(RuntimeError, match="needs the attention kernels"):
        export_state(
            weights[2], tmp_path / "x.cnx", in_time=IN_TIME, in_channels=3,
            batch_size=2, chip_size=16, device="cuda",
        )


def test_cpu_artifact_calls_never_capture(artifact):
    """A CPU artifact runs its module eagerly on every call, past the
    warm-ups and the capture a card artifact would make: no capture, no
    replay, and the outputs those of the module's own eager call."""
    pred = load_predictor(artifact)
    counts0 = profiling.counters()
    for seed in range(5):
        x = _wire(seed)
        got = pred(x, LAT, LON)
        on_device = pred.call_on_device(
            torch.from_numpy(x), torch.from_numpy(LAT), torch.from_numpy(LON)
        )
        with torch.inference_mode():
            want = pred._module(
                torch.from_numpy(x), torch.from_numpy(LAT), torch.from_numpy(LON)
            )
        for name, w, d in zip(("distance", "edge", "crop"), want, on_device):
            np.testing.assert_array_equal(got[name], w.numpy(), err_msg=name)
            assert torch.equal(d, w), name
    counts = profiling.counters()
    assert counts["graph_captures"] == counts0["graph_captures"]
    assert counts["graph_replays"] == counts0["graph_replays"]
    assert pred._key is None and pred._graph is None


def _card_call(**changed):
    """Stand-ins for (x, lat, lon) of a batch-2 card artifact: the device,
    shape and dtype the rule reads, each as the artifact's unless
    ``changed`` names it (``x_device``, ``lat_shape``, ...)."""
    card = torch.device("cuda", 0)
    specs = {"x": (X_SHAPE, torch.int16), "lat": ((2,), torch.float32),
             "lon": ((2,), torch.float32)}
    return [
        SimpleNamespace(
            device=changed.get(f"{name}_device", card),
            shape=torch.Size(changed.get(f"{name}_shape", shape)),
            dtype=changed.get(f"{name}_dtype", dtype),
        )
        for name, (shape, dtype) in specs.items()
    ]


@pytest.mark.parametrize(
    "platform,changed,reason",
    [
        ("cuda", {}, None),
        ("cpu", {}, "not a card artifact"),
        ("cuda", {"x_device": torch.device("cpu")}, "not on one card"),
        ("cuda", {"lon_device": torch.device("cpu")}, "not on one card"),
        ("cuda", {"lat_device": torch.device("cuda", 1)}, "not on one card"),
        ("cuda", {"x_shape": (1, *X_SHAPE[1:])}, "x is not"),
        ("cuda", {"x_shape": (2, IN_TIME, 16, 18, 3)}, "x is not"),
        ("cuda", {"lat_shape": (3,)}, "lat is not"),
        ("cuda", {"x_dtype": torch.float32}, "x is not"),
        ("cuda", {"lon_dtype": torch.float64}, "lon is not"),
    ],
)
def test_engagement_rule_keeps_each_excluded_call_eager(artifact, platform, changed, reason):
    with zipfile.ZipFile(artifact) as zf:
        meta = json.loads(zf.read("meta.json").decode())
    meta["platforms"] = [platform]
    got = eager_reason(meta, *_card_call(**changed))
    if reason is None:
        assert got is None
    else:
        assert got is not None and reason in got


def test_plan_warms_up_captures_replays_and_starts_over(artifact, monkeypatch):
    """``_graphed`` follows its plan: ``WARMUP`` eager calls that ran, the
    capture, then replays, each of the last two counted as one replay;
    another card or other backend settings drop the graph and warm up
    again. The card's work is stubbed here; the card test runs it."""
    pred = load_predictor(artifact)
    actions = []

    def eager(inputs):
        actions.append("eager")
        return "eager outputs"

    def capture(inputs):
        actions.append("capture")
        pred._graph = object()  # what a capture leaves
        return "clones"

    def replay(inputs):
        actions.append("replay")
        return "clones"

    monkeypatch.setattr(pred, "_on_side_stream", eager)
    monkeypatch.setattr(pred, "_capture", capture)
    monkeypatch.setattr(pred, "_replay", replay)
    settings = export_module._backend_settings()
    monkeypatch.setattr(export_module, "_backend_settings", lambda: settings)
    inputs = tuple(torch.from_numpy(v) for v in (_wire(0), LAT, LON))

    def calls(n):
        del actions[:]
        replays = profiling.COUNTS["graph_replays"]
        outs = [pred._graphed(inputs) for _ in range(n)]
        return actions[:], outs, profiling.COUNTS["graph_replays"] - replays

    assert export_module.WARMUP == 2
    assert calls(5) == (
        ["eager", "eager", "capture", "replay", "replay"],
        ["eager outputs"] * 2 + ["clones"] * 3, 3,
    )
    # A warm-up the module rejected (it raised before ``_warm`` moved)
    # brings the capture no nearer.
    def rejected(inputs):
        raise RuntimeError("the module refused the inputs")

    monkeypatch.setattr(pred, "_on_side_stream", rejected)
    on_card_1 = (SimpleNamespace(device=torch.device("cuda", 1)),) + inputs[1:]
    for _ in range(3):
        with pytest.raises(RuntimeError):
            pred._graphed(on_card_1)
    assert pred._warm == 0 and pred._graph is None
    monkeypatch.setattr(pred, "_on_side_stream", eager)
    assert calls(1)[0] == ["eager"]  # back on the first card: a new key
    settings = settings[:2] + (not settings[2],) + settings[3:]
    assert calls(4)[0] == ["eager", "eager", "capture", "replay"]


def test_backend_settings_follow_the_flags(monkeypatch):
    settings = export_module._backend_settings()
    monkeypatch.setattr(torch.backends.cudnn, "deterministic",
                        not torch.backends.cudnn.deterministic)
    assert export_module._backend_settings() != settings
