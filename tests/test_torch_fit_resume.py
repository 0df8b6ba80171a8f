"""The port's fit loop on its own, on the CPU, at the CLI-default model
shape cut to hidden 4 (NA attention, dilations [1, 2], dropout 0.2) on
16 x 16 chips: resume, checkpoints, the model restored for predict,
stochastic weight averaging, the test metrics and the batch metrics.

Resume: a 2-epoch run followed by ``epochs=3`` on the same checkpoint
equals an uninterrupted 3-epoch run bit for bit. The checkpoint carries
the optimizer's and the dropout generator's state, and the resumed loader
replays the finished epochs' shuffles. The schedule here is
ExponentialLR, whose value at a step does not depend on the number of
epochs; OneCycle's horizon is ``epochs``, so with it a 2-epoch run is not
the start of a 3-epoch one, in either package.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from cultionet_tpu_torch.config import CultionetParams
from cultionet_tpu_torch.data.datasets import ChipDataset
from cultionet_tpu_torch.data.synthetic import create_batch
from cultionet_tpu_torch.model import fit, load_model
from cultionet_tpu_torch.predict import ScenePredictor
from cultionet_tpu_torch.train.checkpoint import Checkpointer
from cultionet_tpu_torch.utils.normalize import NormValues

CONFIG = dict(
    val_frac=0.2,
    batch_size=2,
    hidden_channels=4,
    dilations=[1, 2],
    attention_weights="natten",
    dropout=0.2,
    learning_rate=1e-3,
    lr_scheduler="ExponentialLR",
    precision="32",
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch CPU thread for this module: the test runner's workers
    share the cores, and torch's thread pool on these small tensors then
    slows down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def chips(tmp_path_factory):
    root = tmp_path_factory.mktemp("chips")
    rng = np.random.default_rng(7)
    for _ in range(10):
        batch = create_batch(
            num_channels=3, num_time=6, height=16, width=16, rng=rng
        )
        batch.to_file(root / "processed" / batch.batch_id[0])
    return root


def run(chips, ckpt: Path, **kwargs):
    """One fit on a fresh dataset object, as a new process would build."""
    params = CultionetParams(
        ckpt_file=ckpt / "last.ckpt",
        dataset=ChipDataset(chips),
        **{**CONFIG, **kwargs},
    )
    return fit(params, device="cpu")


def test_resume_equals_uninterrupted(chips, tmp_path):
    first = run(chips, tmp_path / "a", epochs=2)
    assert [r["epoch"] for r in first.history] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in first.history)
    resumed = run(chips, tmp_path / "a", epochs=3)
    whole = run(chips, tmp_path / "b", epochs=3)

    assert [r["epoch"] for r in resumed.history] == [2]
    assert resumed.history[0] == whole.history[2]
    assert resumed.state.step == whole.state.step == 12
    got, want = resumed.state.model.state_dict(), whole.state.model.state_dict()
    for name, value in want.items():
        assert torch.equal(got[name], value), name
    rows = (tmp_path / "a" / "history.csv").read_text().splitlines()
    assert len(rows) == 1 + 3
    meta = json.loads(
        (tmp_path / "a" / "last_store" / "last.meta.json").read_text()
    )
    assert set(meta) == {"epoch", "step", "metrics", "hyperparams"}
    assert meta["epoch"] == 2 and meta["step"] == 12


def test_checkpoint_round_trip(chips, tmp_path):
    result = run(chips, tmp_path, epochs=1)
    state = result.state
    generator = torch.Generator().manual_seed(5)
    generator.manual_seed(6)
    ckpt = Checkpointer(tmp_path / "store")
    ckpt.save_best(state, 0, metrics={"val_score": 1.5}, generator=generator)
    want_gen = generator.get_state()
    want_opt = state.optimizer.state_dict()

    fresh = run(chips, tmp_path / "other", epochs=1, random_seed=1).state
    fresh_gen = torch.Generator()
    ckpt.restore(fresh, "best", generator=fresh_gen)
    for name, value in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[name], value), name
    assert fresh.step == state.step
    assert torch.equal(fresh_gen.get_state(), want_gen)
    got_opt = fresh.optimizer.state_dict()
    assert got_opt["count"] == want_opt["count"]
    for key, entry in want_opt["torch_optimizer"]["state"].items():
        for name, value in entry.items():
            assert torch.equal(
                got_opt["torch_optimizer"]["state"][key][name], value
            )
    assert ckpt.load_meta("best")["metrics"] == {"val_score": 1.5}

    # An inference restore leaves the optimizer untouched.
    other = run(chips, tmp_path / "third", epochs=1, random_seed=2).state
    before = other.optimizer.state_dict()["count"]
    ckpt.restore(other, "best", with_opt_state=False)
    assert other.optimizer.state_dict()["count"] == before


def test_load_model_predicts_a_scene(chips, tmp_path):
    run(chips, tmp_path, epochs=1)
    state, model = load_model(tmp_path / "last_store", device="cpu")
    assert not model.training and state.model is model
    scene = (
        np.random.default_rng(0).random((6, 40, 36, 3)) * 10000
    ).astype("int16")
    raster, size = ScenePredictor(model, batch_size=2, device="cpu").predict_scene(
        scene, window_size=16, padding=4
    )
    assert size == (40, 36) and raster.shape == (40, 36, 3)
    assert np.isfinite(raster).all() and 0 <= raster.min() <= raster.max() <= 1
    with pytest.raises(FileNotFoundError):
        load_model(tmp_path / "missing", device="cpu")


def test_swa_test_metrics_batch_metrics_and_norm(chips, tmp_path):
    info = {"max_crop_class": 1, "edge_class": 2}
    norm = NormValues.from_dataset(ChipDataset(chips), info)
    dataset = ChipDataset(chips, norm_values=norm)
    params = CultionetParams(
        ckpt_file=tmp_path / "last.ckpt",
        dataset=dataset,
        test_dataset=ChipDataset(chips, norm_values=norm),
        stochastic_weight_averaging=True,
        stochastic_weight_averaging_start=0.5,
        save_batch_val_metrics=True,
        scale_pos_weight=True,
        epochs=2,
        **CONFIG,
    )
    result = fit(params, device="cpu")
    assert len(result.history) == 2
    meta = json.loads((tmp_path / "last_store" / "last.meta.json").read_text())
    assert meta["metrics"] == {"swa": 1.0}
    assert meta["hyperparams"]["normalized_input"] is True
    metrics = json.loads((tmp_path / "test.metrics").read_text())
    assert {"loss", "score", "edge_f1", "crop_f1"} <= set(metrics)
    assert all(np.isfinite(v) for v in metrics.values())
    written = list(tmp_path.glob("batch_metrics.*"))
    assert len(written) == 1


def test_fit_needs_cuda_by_default(chips, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = CultionetParams(dataset=ChipDataset(chips), epochs=1, **CONFIG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit(params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_model("anywhere")
