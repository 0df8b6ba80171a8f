"""The port's command line (``cultionet_tpu_torch/scripts/cli.py``,
``python -m cultionet_tpu_torch``) against the JAX package's, on the CPU
(``main(argv, device="cpu")``).

- The argument spec ``scripts/args.json`` equals ``yaml.safe_load`` of the
  JAX ``args.yml`` but for help texts, and each subcommand's parser has the
  JAX parser's flags, dests, defaults, types, choices, nargs and consts.
- ``_build_params`` gives the JAX ``CultionetParams`` field for field.
- On ``tests/test_cli.py::make_project``'s layout, ``create`` and
  ``create-predict`` write the JAX CLI's files with equal arrays (cv2 on
  its own distance code, see ``test_torch_label_math.py``), and
  ``_norm_values`` gives JAX's ``NormValues``.
- ``train`` (1 epoch, hidden 8) writes ``last``/``best``, the norm file,
  ``classes.info`` and the commands archive, and ``--profiler`` a trace
  and ``spans.json`` with the fit loop's and the step's spans;
  ``skfoldcv --k-folds 2`` fits two folds; ``version`` prints.
- ``predict`` with the trained conv checkpoint ``tests/data/golden/ckpt``
  (translated into a port store) matches ``golden.tif`` on >= 99.9% of
  pixels. The JAX ``predict`` never reads the checkpoint's
  ``log_transform``; the port does. With the flag false (the golden
  checkpoint) the two agree through ``golden.tif``; with it true the port
  log-transforms the chips.
- ``train-transfer`` writes its own store from the trained one, training
  only the heads at ``--finetune fc``; ``export --platform cpu`` writes an
  artifact that serves as the checkpoint's eager serve program does, and
  ``--platform tpu`` is refused by name; ``skfoldcv`` over a partition
  file fits one fold per named polygon, and ``train --spatial-partitions
  FILE --partition-name NAME`` validates on that polygon's chips.
- ``main`` with ``device="cuda"`` and no card raises. ``import-torch``
  is held against the JAX command in ``test_torch_import_torch.py``.
"""

import dataclasses
import json
import shutil
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
import yaml

cv2 = pytest.importorskip("cv2")

from cultionet_tpu.data.datasets import ChipDataset as JaxDataset  # noqa: E402
from cultionet_tpu.scripts import cli as jax_cli  # noqa: E402
from cultionet_tpu.utils.project_paths import setup_paths as jax_setup_paths  # noqa: E402
from cultionet_tpu_torch.data.datasets import ChipDataset  # noqa: E402
from cultionet_tpu_torch.scripts import cli  # noqa: E402
from cultionet_tpu_torch.utils.project_paths import setup_paths  # noqa: E402

from test_cli import make_project  # noqa: E402
from torch_port_helpers import one_torch_thread  # noqa: E402,F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
GOLDEN = Path(__file__).parent / "data" / "golden"
SMALL_TRAIN = [
    "--epochs", "1", "--hidden-channels", "8", "--batch-size", "1",
    "--val-frac", "0.34", "--precision", "32",
]


@pytest.fixture(autouse=True)
def opencv_own_code():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


def run_jax_cli(argv):
    with mock.patch.object(sys, "argv", ["cultionet-tpu"] + list(argv)):
        jax_cli.main()


def test_args_spec_equals_jax_yaml():
    port = json.loads(cli.ARGS_SPEC.read_text())
    jax = yaml.safe_load(jax_cli.ARGS_SPEC.read_text())
    assert list(port) == list(jax)
    for group, args in jax.items():
        assert list(port[group]) == list(args), group
        for dest, arg in args.items():
            got = port[group][dest]
            assert got["flags"] == arg["flags"], dest
            strip = lambda kw: {k: v for k, v in kw.items() if k != "help"}  # noqa: E731
            assert strip(got["kwargs"]) == strip(arg["kwargs"]), dest


def _actions(parser, command):
    sub = parser._subparsers._group_actions[0].choices[command]
    return [
        (a.dest, tuple(a.option_strings), a.default, a.type, a.choices,
         a.nargs, a.const, a.required)
        for a in sub._actions
        if a.dest != "help"
    ]


@pytest.mark.parametrize("command", [str(c) for c in cli.SUBCOMMAND_GROUPS])
def test_parser_matches_jax(command):
    assert _actions(cli.build_parser(), command) == _actions(
        jax_cli.build_parser(), command
    )


@pytest.mark.parametrize(
    "extra",
    [
        [],
        ["--attention-weights", "none", "--dropout", "0.1", "--dilations", "1",
         "--temporal-encoder", "transformer", "--optimizer", "SGD",
         "--lr-scheduler", "StepLR", "--steplr-step-size", "3", "--swa",
         "--swa-lr", "0.1", "--edge-class", "5", "--spatial-partitions",
         "--precision", "32", "--augment-prob", "0.0", "--scale-pos-weight",
         "--save-batch-val-metrics", "--random-seed", "7", "--skip-train"],
        ["--use-chipstore", "--devices", "2", "--device-augment", "--fsdp",
         "--lr-find", "--model-pruning", "--profiler", "trace"],
    ],
    ids=["defaults", "options", "unported"],
)
def test_build_params_matches_jax(tmp_path, extra):
    project = tmp_path / "project"
    argv = ["train", "-p", str(project), *extra]
    port_args = cli.build_parser().parse_args(argv)
    jax_args = jax_cli.build_parser().parse_args(argv)
    got = cli._build_params(port_args, setup_paths(project), None)
    want = jax_cli._build_params(jax_args, jax_setup_paths(project), None)
    names = [f.name for f in dataclasses.fields(want)]
    assert names == [f.name for f in dataclasses.fields(got)]
    for name in names:
        assert getattr(got, name) == getattr(want, name), name


def _chip_arrays(root: Path) -> dict:
    out = {}
    for path in sorted(root.glob("*.npz")):
        with np.load(path) as data:
            out[path.name] = {k: data[k] for k in data.files}
    return out


def _assert_same_chips(got_root: Path, want_root: Path) -> None:
    got, want = _chip_arrays(got_root), _chip_arrays(want_root)
    assert list(got) == list(want) and want
    for name, arrays in want.items():
        assert list(got[name]) == list(arrays), name
        for key, value in arrays.items():
            assert got[name][key].dtype == value.dtype, (name, key)
            np.testing.assert_array_equal(got[name][key], value, err_msg=f"{name}:{key}")


@pytest.mark.parametrize(
    "create_args",
    [[], ["--num-workers", "1", "--all-touched", "--bbox-offsets", "0,8",
          "--bbox-offsets=-8,0", "--zero-padding", "2"]],
    ids=["defaults", "knobs"],
)
def test_create_and_create_predict_match_jax(tmp_path, create_args):
    port_project = make_project(tmp_path / "port", num_regions=3)
    jax_project = make_project(tmp_path / "jax", num_regions=3)
    cli.main(["create", "-p", str(port_project), *create_args], device="cpu")
    run_jax_cli(["create", "-p", str(jax_project), *create_args])
    _assert_same_chips(
        port_project / "data/train/processed", jax_project / "data/train/processed"
    )
    predict_args = ["--regions", "000001", "--window-size", "24", "--padding", "6",
                    *create_args[:2]]
    cli.main(["create-predict", "-p", str(port_project), *predict_args], device="cpu")
    run_jax_cli(["create-predict", "-p", str(jax_project), *predict_args])
    _assert_same_chips(
        port_project / "data/predict/processed",
        jax_project / "data/predict/processed",
    )
    assert (port_project / "data/classes.info").read_text() == (
        jax_project / "data/classes.info"
    ).read_text()

    # The normalization statistics over the same chips.
    got = cli._norm_values(
        setup_paths(port_project), ChipDataset(port_project / "data/train"), 2
    )
    want = jax_cli._norm_values(
        jax_setup_paths(jax_project), JaxDataset(jax_project / "data/train"), 2
    )
    for name in ("dataset_mean", "dataset_std", "lower_bound", "upper_bound",
                 "dataset_crop_counts", "dataset_edge_counts"):
        np.testing.assert_allclose(
            np.asarray(getattr(got, name)), np.asarray(getattr(want, name)),
            rtol=1e-6, err_msg=name,
        )
    assert (port_project / "ckpt/last.norm.npz").is_file()


def test_train_writes_checkpoints_and_archive(tmp_path):
    project = make_project(tmp_path, num_regions=3)
    cli.main(["create", "-p", str(project), "--num-workers", "1"], device="cpu")
    trace = tmp_path / "trace"
    cli.main(
        ["train", "-p", str(project), *SMALL_TRAIN, "--profiler", str(trace)],
        device="cpu",
    )
    store = project / "ckpt" / "last_store"
    for which in ("last", "best"):
        assert (store / which / "model.pt").is_file()
        meta = json.loads((store / f"{which}.meta.json").read_text())
        assert meta["hyperparams"]["hidden_channels"] == 8
        assert meta["hyperparams"]["log_transform"] is False
    assert (project / "ckpt" / "last.norm.npz").is_file()
    assert (project / "ckpt" / "history.csv").is_file()
    assert (trace / "trace.json").stat().st_size > 0
    spans = json.loads((trace / "spans.json").read_text())["spans"]
    assert {"fit.data_wait", "fit.validate", "fit.save", "train.step",
            "train.forward", "train.backward", "train.optimizer"} <= set(spans)
    # One wait more than steps: the one that finds the epoch's end.
    assert spans["fit.data_wait"]["count"] == spans["train.step"]["count"] + 1
    assert spans["fit.validate"]["count"] == spans["fit.save"]["count"] == 1
    archived = sorted((project / "commands").glob("*.json"))
    assert [p.name.split("_")[0] for p in archived] == ["create", "train"]
    payload = json.loads(archived[1].read_text())
    assert payload["command"].startswith("cultionet-tpu-torch train -p")
    assert payload["args"]["hidden_channels"] == 8
    assert json.loads((project / "data" / "classes.info").read_text()) == {
        "max_crop_class": 1, "edge_class": 2,
    }


def test_skfoldcv_fits_each_fold(tmp_path):
    project = make_project(tmp_path, num_regions=4)
    cli.main(["create", "-p", str(project), "--num-workers", "1"], device="cpu")
    cli.main(
        ["skfoldcv", "-p", str(project), "--k-folds", "2", *SMALL_TRAIN],
        device="cpu",
    )
    scores = json.loads((project / "ckpt" / "skfoldcv.json").read_text())
    assert sorted(scores) == ["fold0", "fold1"]
    assert all(np.isfinite(v) for v in scores.values())
    for fold in scores:
        assert (project / "ckpt" / f"{fold}_store" / "last" / "model.pt").is_file()
        assert (project / "ckpt" / "test.metrics").is_file()


@pytest.fixture(scope="module")
def golden_store(tmp_path_factory):
    """The trained conv golden checkpoint as a port checkpoint store."""
    from cultionet_tpu_torch.models import CultioNet
    from cultionet_tpu_torch.train.checkpoint import Checkpointer
    from cultionet_tpu_torch.train.optim import build_optimizer
    from cultionet_tpu_torch.train.step import create_train_state
    from cultionet_tpu_torch.utils.params import load_flax

    from torch_port_helpers import restore_golden_checkpoint

    state, jax_model = restore_golden_checkpoint(GOLDEN / "ckpt" / "last_store")
    model = CultioNet(
        in_time=jax_model.in_time,
        hidden_channels=jax_model.hidden_channels,
        dilations=jax_model.dilations,
        dropout=jax_model.dropout,
        activation_type=jax_model.activation_type,
        attention_weights=jax_model.attention_weights,
    )
    load_flax(model, {"params": state.params, "batch_stats": state.batch_stats})
    meta = json.loads((GOLDEN / "ckpt" / "last_store" / "last.meta.json").read_text())
    store = tmp_path_factory.mktemp("golden") / "last_store"
    port_state = create_train_state(model, build_optimizer("AdamW", 1e-3), device="cpu")
    Checkpointer(store).save_last(
        port_state, meta["epoch"], meta["metrics"], meta["hyperparams"]
    )
    return store


def _golden_project(root: Path, store: Path) -> Path:
    project = root / "project"
    region = project / "time_series_vars" / "golden"
    region.mkdir(parents=True)
    shutil.copy(GOLDEN / "scene.npz", region / "scene.npz")
    shutil.copytree(store, project / "ckpt" / "last_store")
    cli.main(
        ["create-predict", "-p", str(project), "--window-size", "50",
         "--padding", "10", "--num-workers", "1"],
        device="cpu",
    )
    return project


def _read_raster(path: Path):
    from cultionet_tpu_torch.data.tiny_tiff import read_tiff

    return read_tiff(path)


def test_predict_golden_checkpoint(tmp_path, golden_store):
    """JAX's predict wrote ``golden.tif`` without reading the checkpoint's
    ``log_transform``; the port reads it, and with the flag false (this
    checkpoint) it agrees."""
    project = _golden_project(tmp_path, golden_store)
    out = project / "out" / "golden.tif"
    cli.main(
        ["predict", "-p", str(project), "--region", "golden", "-o", str(out),
         "--predict-batch-size", "4"],
        device="cpu",
    )
    raster, bounds, res, crs = _read_raster(out)
    golden, *_ = _read_raster(GOLDEN / "golden.tif")
    assert raster.shape == golden.shape == (3, 100, 100)
    match = float(np.mean(raster == golden))
    assert match >= 0.999, match
    with np.load(GOLDEN / "scene.npz") as data:
        want_bounds = tuple(float(np.float32(v)) for v in data["bounds"])
        assert crs == str(data["crs"])
    np.testing.assert_allclose(bounds, want_bounds, rtol=0, atol=1e-6)
    assert res == pytest.approx(10.0, abs=1e-3)


def test_predict_reads_log_transform(tmp_path, golden_store):
    """With ``log_transform`` true in the checkpoint, ``predict`` equals
    predicting the log-transformed chips through the API."""
    from cultionet_tpu_torch.model import load_model
    from cultionet_tpu_torch.predict import ScenePredictor

    project = _golden_project(tmp_path, golden_store)
    store = project / "ckpt" / "last_store"
    meta_path = store / "last.meta.json"
    meta = json.loads(meta_path.read_text())
    meta["hyperparams"]["log_transform"] = True
    meta_path.write_text(json.dumps(meta))

    cli.main(
        ["predict", "-p", str(project), "--region", "golden", "-o",
         str(project / "log.tif"), "--predict-batch-size", "4"],
        device="cpu",
    )
    raster, *_ = _read_raster(project / "log.tif")
    golden, *_ = _read_raster(GOLDEN / "golden.tif")
    assert float(np.mean(raster == golden)) < 0.9

    _, model = load_model(store, "last", device="cpu")
    dataset = ChipDataset(project / "data" / "predict", pattern="data_golden*",
                          log_transform=True)
    api = ScenePredictor(model, batch_size=4, device="cpu").predict_to_raster(
        dataset, project / "api.tif"
    )
    want, *_ = _read_raster(api)
    np.testing.assert_array_equal(raster, want)


def test_predict_transfer_reads_its_store(tmp_path, golden_store):
    project = _golden_project(tmp_path, golden_store)
    with pytest.raises(FileNotFoundError):
        cli.main(["predict-transfer", "-p", str(project)], device="cpu")
    shutil.copytree(golden_store, project / "ckpt" / "last_transfer_store")
    written = cli.predict_image(
        cli.build_parser().parse_args(["predict-transfer", "-p", str(project)]),
        transfer=True, device="cpu",
    )
    assert written.name == "scene_0_1.tif" and written.is_file()


def test_version_prints(capsys):
    from cultionet_tpu_torch import __version__

    cli.main(["version"], device="cpu")
    assert capsys.readouterr().out.strip() == __version__


def test_python_dash_m_entry_point():
    """``python -m cultionet_tpu_torch`` parses its arguments, and without a
    card refuses to run rather than carry on on the CPU."""
    run = lambda *argv: subprocess.run(  # noqa: E731
        [sys.executable, "-m", "cultionet_tpu_torch", *argv],
        capture_output=True, text=True, timeout=120, cwd=REPO,
    )
    out = run("--help")
    assert out.returncode == 0, out.stderr
    for command in cli.SUBCOMMAND_GROUPS:
        assert str(command) in out.stdout
    if not torch.cuda.is_available():
        out = run("version")
        assert out.returncode != 0
        assert "device='cpu'" in out.stderr


@pytest.fixture(scope="module")
def trained_project(tmp_path_factory):
    """``create`` and a 1-epoch ``train`` (hidden 8) on 3 regions."""
    project = make_project(tmp_path_factory.mktemp("trained"), num_regions=3)
    cli.main(["create", "-p", str(project), "--num-workers", "1"], device="cpu")
    cli.main(["train", "-p", str(project), *SMALL_TRAIN], device="cpu")
    return project


def _model_file(store, which="last"):
    return torch.load(store / which / "model.pt", weights_only=True)["params"]


def test_train_transfer_writes_its_store(trained_project, tmp_path):
    project = shutil.copytree(trained_project, tmp_path / "project")
    cli.main(
        ["train-transfer", "-p", str(project), *SMALL_TRAIN, "--finetune",
         "fc"],
        device="cpu",
    )
    store = project / "ckpt" / "last_transfer_store"
    for which in ("last", "best"):
        assert (store / which / "model.pt").is_file()
    pretrained = _model_file(project / "ckpt" / "last_store")
    transferred = _model_file(store)
    assert set(pretrained) == set(transferred)
    heads = [n for n in pretrained
             if any(p.startswith("final_") for p in n.split("."))]
    assert heads
    for name, value in pretrained.items():
        if name in heads:
            continue
        assert torch.equal(transferred[name], value), name
    assert any(not torch.equal(transferred[n], pretrained[n]) for n in heads)
    archived = sorted((project / "commands").glob("train-transfer_*.json"))
    assert len(archived) == 1


def test_export_serves_like_the_checkpoint(trained_project, tmp_path):
    """``export --platform cpu`` writes ``ckpt/serve_best.cnx``; served on a
    wire batch it equals the eager serve program of the same checkpoint
    and norm statistics."""
    from cultionet_tpu_torch.export import build_serve_fn, load_predictor
    from cultionet_tpu_torch.model import load_model
    from cultionet_tpu_torch.utils.normalize import NormValues

    project = shutil.copytree(trained_project, tmp_path / "project")
    cli.main(
        ["export", "-p", str(project), "--platform", "cpu", "--chip-size",
         "32", "--export-batch-size", "2", "--precision", "fp32"],
        device="cpu",
    )
    pred = load_predictor(project / "ckpt" / "serve_best.cnx")
    assert pred.meta["platforms"] == ["cpu"] and pred.meta["kernels"] == "plain"
    assert pred.meta["normalized"] is True and pred.meta["log_transform"] is False
    assert pred.meta["ops"] == {"cultionet_tpu_torch::na2d": 3}
    x = np.random.default_rng(0).integers(
        0, 10000, size=(2, 6, 32, 32, 2), dtype=np.int16
    )
    lat = lon = np.zeros(2, np.float32)
    served = pred(x, lat, lon)
    _, model = load_model(project / "ckpt" / "last_store", "best", device="cpu")
    norm = NormValues.from_file(project / "ckpt" / "last.norm.npz")
    serve = build_serve_fn(
        model, norm.dataset_mean, norm.dataset_std, precision="fp32"
    )
    with torch.no_grad():
        direct = serve(torch.from_numpy(x), torch.zeros(2), torch.zeros(2))
    for name, d in zip(("distance", "edge", "crop"), direct):
        np.testing.assert_allclose(served[name], d.numpy(), atol=1e-5)


def test_export_refuses_other_platforms(tmp_path):
    with pytest.raises(ValueError, match="--platform tpu"):
        cli.main(["export", "-p", str(tmp_path), "--platform", "tpu"],
                 device="cpu")


def test_partition_file_folds_and_split(tmp_path):
    """A GeoJSON of two named polygons over the 4 regions (offsets 0, 100,
    200, 300): ``skfoldcv`` fits the folds ``low`` and ``high``, each
    validated (as its test set) on its two regions' chips; ``train
    --spatial-partitions FILE --partition-name high`` trains on ``low``."""
    project = make_project(tmp_path, num_regions=4)
    cli.main(["create", "-p", str(project), "--num-workers", "1"], device="cpu")

    def square(lo, hi):
        return [[lo, lo], [hi, lo], [hi, hi], [lo, hi], [lo, lo]]

    parts = tmp_path / "parts.geojson"
    parts.write_text(json.dumps({"type": "FeatureCollection", "features": [
        {"type": "Feature", "properties": {"name": name},
         "geometry": {"type": "Polygon", "coordinates": [square(lo, hi)]}}
        for name, lo, hi in (("low", -10, 180), ("high", 180, 400))
    ]}))
    cli.main(
        ["skfoldcv", "-p", str(project), "--spatial-partitions", str(parts),
         *SMALL_TRAIN],
        device="cpu",
    )
    scores = json.loads((project / "ckpt" / "skfoldcv.json").read_text())
    assert list(scores) == ["low", "high"]
    assert all(np.isfinite(v) for v in scores.values())
    for fold in scores:
        assert (project / "ckpt" / f"{fold}_store" / "last" / "model.pt").is_file()

    cli.main(
        ["train", "-p", str(project), "--spatial-partitions", str(parts),
         "--partition-name", "high", "--save-batch-val-metrics",
         *SMALL_TRAIN],
        device="cpu",
    )
    meta = json.loads(
        (project / "ckpt" / "last_store" / "last.meta.json").read_text()
    )
    assert np.isfinite(meta["metrics"]["val_score"])
    parquet = project / "ckpt" / "batch_metrics.parquet"
    if parquet.exists():
        import pandas as pd

        validated = int(pd.read_parquet(parquet)["num_samples"].sum())
    else:
        lines = (project / "ckpt" / "batch_metrics.csv").read_text().splitlines()
        column = lines[0].split(",").index("num_samples")
        validated = sum(int(row.split(",")[column]) for row in lines[1:])
    assert validated == 2  # the chips of regions 2 and 3


@pytest.mark.parametrize("argv", [["version"], ["create", "-p", "unused"]])
def test_main_on_cuda_without_a_card_raises(monkeypatch, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(argv)


def test_chip_smoke_cli_project(tmp_path):
    """``chip_smoke.py``'s ``cli`` phase project: 20 field-layout regions
    whose chips hold one crop parcel per field (16-25), and the 420 x 420
    predict region."""
    import chip_smoke
    from cultionet_tpu_torch.augment import label_segments

    project = tmp_path / "project"
    fields = chip_smoke.write_cli_project(project)
    assert len(fields) == chip_smoke.CLI_REGIONS
    regions = [f"r{k:02d}" for k in range(chip_smoke.CLI_REGIONS)]
    cli.main(["create", "-p", str(project), "--num-workers", "1", "--regions",
              *regions], device="cpu")
    parcels = []
    for path in sorted((project / "data/train/processed").glob("*.npz")):
        with np.load(path) as data:
            parcels.append(int(label_segments(data["y"][0]).max()))
    assert parcels == fields and all(16 <= n <= 25 for n in parcels)
    with np.load(project / "time_series_vars/predict/scene.npz") as data:
        assert data["x"].shape == (12, 420, 420, 3)
