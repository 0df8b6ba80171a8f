"""Transfer learning (``cultionet_tpu_torch/model.py::fit_transfer``)
against the JAX ``fit(pretrained_state=...)`` on the same pretrained
weights and chips, fp32 on the CPU, dropout 0, one epoch of 4 steps (the
model and chips of ``test_torch_fit.py``). The cases ``finetune="all"``
and "fc" with an active clip are in ``test_torch_transfer_all.py``,
which shares this file's fixtures and check: each JAX ``fit`` traces its
model anew (about 20 s on the CPU), so four cases in one file would take
two minutes.

The port reads the pretrained weights from a checkpoint store
(``<ckpt dir>/last_store``, as ``fit_transfer`` does); JAX gets the same
seeded variables as a ``TrainState``. For each ``finetune`` mode (None:
fresh heads, trained alone; "fc": the pretrained heads, trained alone;
"all": everything) and once with an active gradient clip ("fc" at clip
1e-3, whose global norm counts the frozen gradients, as optax's
``clip_by_global_norm`` before the freezing mask does): the history
within 1e-4 of JAX's, every frozen parameter equal to the pretrained one
bit for bit, and the trained parameters and the BatchNorm running
statistics (updated by train-mode forwards of frozen layers too) within
1e-4 of the largest entry of JAX's. With ``finetune=None`` the port's
fresh heads are JAX's: the port's ``create_train_state`` is given the JAX
initialization of the same seed.
"""

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
from cultionet_tpu_torch.model import fit_transfer
from cultionet_tpu_torch.models import CultioNet
from cultionet_tpu_torch.train import fit as fit_module
from cultionet_tpu_torch.train.checkpoint import Checkpointer
from cultionet_tpu_torch.train.optim import build_optimizer
from cultionet_tpu_torch.train.step import create_train_state
from cultionet_tpu_torch.utils.params import from_flax, load_flax

from torch_port_helpers import seeded_variables

MODEL = dict(hidden_channels=4, dilations=[1], attention_weights=None)
CONFIG = dict(
    val_frac=0.2, batch_size=2, epochs=1, learning_rate=1e-3,
    loss_name="TanimotoComplementLoss", precision="32", dropout=0.0,
    in_channels=3, in_time=6, **MODEL,
)
SEED = 42  # CultionetParams.random_seed in both packages


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
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


@pytest.fixture(scope="module")
def pretrained():
    """The JAX model and its seeded variables (the pretrained model)."""
    jax_model = JaxCultioNet(in_time=6, dropout=0.0, **MODEL)
    variables = seeded_variables(
        jax_model, JaxBatch(x=jnp.zeros((1, 6, 16, 16, 3))), training=False,
        seed=3,
    )
    return jax_model, variables


def jax_fresh_variables(jax_model):
    """JAX's fresh initialization at ``SEED``: the heads ``finetune=None``
    starts from."""
    fresh = jax_step.create_train_state(
        jax_model, optax.sgd(0.0),
        jax_create_batch(num_channels=3, num_time=6, height=16, width=16),
        seed=SEED,
    )
    return {"params": fresh.params, "batch_stats": fresh.batch_stats}


def _is_final(name):
    return any(part in fit_module.FINAL_NAMES for part in name.split("."))


@pytest.mark.parametrize("finetune", [None, "fc"], ids=["none", "fc"])
def test_fit_transfer_matches_jax(
    chips, pretrained, tmp_path, monkeypatch, finetune
):
    check_fit_transfer(chips, pretrained, tmp_path, monkeypatch, finetune)


def check_fit_transfer(chips, pretrained, tmp_path, monkeypatch, finetune,
                       clip=None):
    """Run JAX's ``fit(pretrained_state)`` and the port's ``fit_transfer``
    from the same weights and chips and hold the port to JAX."""
    jax_model, variables = pretrained
    config = {**CONFIG, "finetune": finetune, "gradient_clip_val": clip}
    want = jax_fit(
        JaxParams(
            ckpt_file=tmp_path / "jax" / "last_transfer.ckpt",
            dataset=JaxDataset(chips), **config,
        ),
        pretrained_state=jax_step.TrainState.create(
            apply_fn=jax_model.apply, params=variables["params"],
            batch_stats=variables["batch_stats"], tx=optax.sgd(0.0),
        ),
    )

    # The pretrained store fit_transfer reads by default.
    model = load_flax(CultioNet(in_time=6, dropout=0.0, **MODEL), variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    Checkpointer(tmp_path / "port" / "last_store").save_last(
        create_train_state(model, build_optimizer(), device="cpu"), 0,
        hyperparams={**MODEL, "in_time": 6, "dropout": 0.0, "in_channels": 3},
    )
    if finetune is None:
        # The fresh heads are JAX's (every other mode loads all weights).
        fresh = jax_fresh_variables(jax_model)
        real = fit_module.create_train_state

        def jax_init(model, tx, seed=None, device="cuda"):
            load_flax(model, fresh)
            return real(model, tx, device=device)

        monkeypatch.setattr(fit_module, "create_train_state", jax_init)
    got = fit_transfer(
        CultionetParams(
            ckpt_file=tmp_path / "port" / "last_transfer.ckpt",
            dataset=ChipDataset(chips), **config,
        ),
        device="cpu",
    )

    assert len(got.history) == len(want.history) == CONFIG["epochs"]
    for port_row, jax_row in zip(got.history, want.history):
        for key in ("loss", "val_loss", "val_score", "lr_sch"):
            np.testing.assert_allclose(
                port_row[key], jax_row[key], atol=1e-4, rtol=0, err_msg=key
            )
    state = got.state.model.state_dict()
    want_state = from_flax(
        {"params": want.state.params, "batch_stats": want.state.batch_stats}
    )
    top = max(float(v.abs().max()) for v in want_state.values())
    params = dict(got.state.model.named_parameters())
    heads_moved = False
    for name, value in want_state.items():
        diff = float((state[name] - value).abs().max())
        assert diff <= 1e-4 * top, (name, diff, top)
        if name in params and finetune != "all" and not _is_final(name):
            assert torch.equal(state[name], before[name]), name
        if name in params and _is_final(name):
            start = (
                from_flax(fresh)[name] if finetune is None else before[name]
            )
            heads_moved |= not torch.equal(state[name], start)
    assert heads_moved
    stats = [n for n in want_state if "running_" in n]
    assert stats and any(not torch.equal(state[n], before[n]) for n in stats)
    store = tmp_path / "port" / "last_transfer_store"
    assert (store / "last" / "model.pt").is_file()
    assert (store / "best" / "model.pt").is_file()
