"""The port's fit loop (``cultionet_tpu_torch/train/fit.py``) against the
JAX ``fit`` on the same chips and weights, fp32 on the CPU: both start
from the same seeded variables (the JAX ``TrainState`` through
``load_flax``, ``finetune="all"``) and train 2 epochs at dropout 0 with the
CLI-default optimizer (AdamW, OneCycle with the beta1 cycle, clip 1.0).
Per-epoch ``loss``, ``val_loss`` and ``val_score`` within 1e-4 of JAX's
(measured: 5e-7), final parameters and BatchNorm statistics within 1e-4 of
the largest entry (measured: 2e-6). The model is hidden 4 with dilation 1
and no attention, so that the JAX fit compiles in about 30 s on a cold
cache (with NA and dilations [1, 2] it took 45 s; the same loop agreed as
closely). The CLI-default step with NA is held to the JAX step in
``test_torch_train.py``; ``test_torch_fit_resume.py`` runs the loop with
NA and dropout. Also: a fit at the CLI's default ``augment_prob`` 0.5
ends with finite losses, the options refused until they were ported
train: the device data path, two devices (two CPU ranks that ``fit``
launches; ``test_torch_fit_parallel.py`` holds them to JAX) and FSDP,
which one device ignores as JAX's does (the learning-rate sweep, pruning
and partition files run: ``test_torch_train_options.py``), and the
model options off
the default path train and come back from their checkpoint
(``test_torch_model_options.py`` holds them to JAX).
"""

import csv
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cultionet_tpu.config import CultionetParams as JaxParams
from cultionet_tpu.data import ChipDataset as JaxDataset
from cultionet_tpu.data import create_batch as jax_create_batch
from cultionet_tpu.data.batch import Batch as JaxBatch
from cultionet_tpu.models import CultioNet as JaxCultioNet
from cultionet_tpu.train import step as jax_step
from cultionet_tpu.train.fit import fit as jax_fit
from cultionet_tpu_torch.config import CultionetParams
from cultionet_tpu_torch.data.datasets import ChipDataset
from cultionet_tpu_torch.models import CultioNet
from cultionet_tpu_torch.train.fit import fit
from cultionet_tpu_torch.utils.params import from_flax, load_flax

from torch_port_helpers import seeded_variables

MODEL = dict(hidden_channels=4, dilations=[1], attention_weights=None)
CONFIG = dict(
    val_frac=0.2,
    batch_size=2,
    epochs=2,
    learning_rate=1e-3,
    loss_name="TanimotoComplementLoss",
    precision="32",
    dropout=0.0,
    finetune="all",
    in_channels=3,
    in_time=6,
    **MODEL,
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
    rng = np.random.default_rng(100)
    for _ in range(10):
        batch = jax_create_batch(
            num_channels=3, num_time=6, height=16, width=16, rng=rng
        )
        batch.to_file(root / "processed" / batch.batch_id[0])
    return root


def test_fit_matches_jax(chips, tmp_path):
    jax_model = JaxCultioNet(in_time=6, dropout=0.0, **MODEL)
    variables = seeded_variables(
        jax_model, JaxBatch(x=jnp.zeros((1, 6, 16, 16, 3))), training=False,
        seed=3,
    )
    pretrained = jax_step.TrainState.create(
        apply_fn=jax_model.apply,
        params=variables["params"],
        batch_stats=variables["batch_stats"],
        tx=optax.sgd(0.0),
    )
    want = jax_fit(
        JaxParams(
            ckpt_file=tmp_path / "jax" / "last.ckpt",
            dataset=JaxDataset(chips),
            **CONFIG,
        ),
        pretrained_state=pretrained,
    )
    model = load_flax(CultioNet(in_time=6, dropout=0.0, **MODEL), variables)
    got = fit(
        CultionetParams(
            ckpt_file=tmp_path / "port" / "last.ckpt",
            dataset=ChipDataset(chips),
            **CONFIG,
        ),
        pretrained_state=model.state_dict(),
        device="cpu",
    )

    assert len(got.history) == len(want.history) == 2
    for port_row, jax_row in zip(got.history, want.history):
        assert port_row["epoch"] == jax_row["epoch"]
        for key in ("loss", "val_loss", "val_score", "lr_sch"):
            np.testing.assert_allclose(
                port_row[key], jax_row[key], atol=1e-4, rtol=0, err_msg=key
            )
    assert got.best_score == min(r["val_score"] for r in got.history)
    want_state = from_flax(
        {"params": want.state.params, "batch_stats": want.state.batch_stats}
    )
    state = got.state.model.state_dict()
    top = max(float(v.abs().max()) for v in want_state.values())
    for name, value in want_state.items():
        diff = float((state[name] - value).abs().max())
        assert diff <= 1e-4 * top, (name, diff, top)
    assert got.state.step == 8 and got.state.optimizer.count == 8

    # The same files, with the same keys.
    for which in ("last", "best"):
        jax_meta = json.loads(
            (tmp_path / "jax" / "last_store" / f"{which}.meta.json").read_text()
        )
        meta = json.loads(
            (tmp_path / "port" / "last_store" / f"{which}.meta.json").read_text()
        )
        assert set(meta) == set(jax_meta)
        assert meta["hyperparams"] == jax_meta["hyperparams"]
        assert (tmp_path / "port" / "last_store" / which / "model.pt").exists()
        assert (tmp_path / "port" / "last_store" / which / "opt.pt").exists()
    with open(tmp_path / "port" / "history.csv") as fh:
        rows = list(csv.DictReader(fh))
    with open(tmp_path / "jax" / "history.csv") as fh:
        jax_rows = list(csv.DictReader(fh))
    assert [r["epoch"] for r in rows] == ["0", "1"]
    assert list(rows[0]) == list(jax_rows[0])


def test_fit_with_host_augmentation(tmp_path):
    """The CLI's default augment_prob 0.5 at hidden 8 with NA, dilations
    [1, 2] and dropout 0.2: 2 epochs with finite losses, the train chips
    augmented in the loader's thread (20 x 20 chips: Perlin noise needs
    sides divisible by 10)."""
    root = tmp_path / "chips"
    rng = np.random.default_rng(101)
    for _ in range(10):
        batch = jax_create_batch(
            num_channels=3, num_time=6, height=20, width=20, rng=rng
        )
        batch.to_file(root / "processed" / batch.batch_id[0])
    dataset = ChipDataset(root)
    params = CultionetParams(
        ckpt_file=tmp_path / "ckpt" / "last.ckpt",
        dataset=dataset,
        **{
            **CONFIG,
            "hidden_channels": 8,
            "dilations": [1, 2],
            "attention_weights": "natten",
            "dropout": 0.2,
            "augment_prob": 0.5,
        },
    )
    got = fit(params, device="cpu")
    assert [row["epoch"] for row in got.history] == [0, 1]
    for row in got.history:
        for key in ("loss", "val_loss", "val_score"):
            assert np.isfinite(row[key]), (key, row)
    assert got.state.step == 8
    assert (tmp_path / "ckpt" / "last_store" / "best" / "model.pt").exists()


@pytest.mark.parametrize(
    "option",
    [
        dict(device_augment=True),
        dict(use_chipstore=True),
        dict(use_chipstore="hbm"),
        dict(devices=2),
        dict(fsdp=True),
    ],
    ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()),
)
def test_unported_options_raise(chips, option, tmp_path):
    """The options refused until they were ported (the test keeps that
    name) train an epoch with finite losses: the device data path
    (``device_augment``, ``use_chipstore``; ``tests/test_torch_device_cache.py``
    and ``test_torch_chipstore.py`` hold it to JAX), two devices (two CPU
    ranks; ``test_torch_fit_parallel.py``) and FSDP (on one device a
    no-op, as in JAX)."""
    params = CultionetParams(
        ckpt_file=tmp_path / "ckpt" / "last.ckpt",
        dataset=ChipDataset(chips),
        **{**CONFIG, "epochs": 1, **option},
    )
    got = fit(params, device="cpu")
    assert got.state.step == 4
    for key in ("loss", "val_loss", "val_score"):
        assert np.isfinite(got.history[0][key]), key


@pytest.mark.parametrize(
    "option",
    [
        dict(use_latlon=True),
        dict(pool_by_max=True),
        dict(batchnorm_first=True),
        dict(remat=True),
        dict(res_block_type="res"),
    ],
    ids=lambda o: next(iter(o)),
)
def test_unported_model_options_raise(chips, option, tmp_path):
    """The model options ``fit`` refused until they were ported (the test
    keeps that name) now train: one epoch with finite losses, and
    ``load_model`` rebuilds the option from the checkpoint's
    hyperparams."""
    from cultionet_tpu_torch.model import load_model

    params = CultionetParams(
        ckpt_file=tmp_path / "ckpt" / "last.ckpt",
        dataset=ChipDataset(chips),
        **{**CONFIG, "epochs": 1, **option},
    )
    got = fit(params, device="cpu")
    assert got.state.step == 4
    for key in ("loss", "val_loss", "val_score"):
        assert np.isfinite(got.history[0][key]), key
    _, model = load_model(tmp_path / "ckpt" / "last_store", device="cpu")
    tower = model.mask_model
    (name, value), = option.items()
    built = {
        "use_latlon": lambda: tower.tower_fusion.tower_a.geo_embeddings
        is not None,
        "pool_by_max": lambda: tower.encoder.down_b.pool_by_max,
        "batchnorm_first": lambda: tower.encoder.down_b.pool_conv.bias
        is not None,
        "remat": lambda: tower.remat,
        "res_block_type": lambda: tower.encoder.down_b.block
        == "ResidualConv_0",
    }
    assert built[name](), name
    assert torch.equal(
        model.state_dict()["mask_model.final_combine.dist_gamma1"],
        got.state.model.state_dict()["mask_model.final_combine.dist_gamma1"],
    )
