"""The port's ``fit`` on two CPU ranks that it launches itself
(``devices=2, device="cpu"``: gloo), against the JAX ``fit(devices=2)`` on
two host devices from the same weights, and against itself.

12 chips of 16 x 16, hidden 4 with dilation 1 and no attention (so that
the JAX fit compiles quickly), fp32, dropout 0, batch 4, val_frac 0.25
(9 train chips: 2 steps an epoch; 3 validation chips: a batch the two
ranks do not divide, which runs whole on each, as JAX's fallback does),
AdamW with ExponentialLR (a schedule that does not depend on the number
of epochs, so a 1-epoch run is the start of a 2-epoch one).

- 2 epochs against JAX: ``loss``, ``val_loss``, ``val_score`` and
  ``lr_sch`` within 1e-4 (the tolerance of ``test_torch_fit.py``'s
  single-device comparison), the final parameters and statistics within
  1e-4 of the largest entry; the checkpoint rank 0 wrote loads through
  ``load_model`` and holds the returned weights;
- a batch the device count does not divide is refused before any rank
  starts.

FSDP and resume on two ranks: ``test_torch_fit_parallel_resume.py``,
which takes this module's setup and fixtures.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cultionet_tpu.config import CultionetParams as JaxParams
from cultionet_tpu.data import ChipDataset as JaxDataset
from cultionet_tpu.data.batch import Batch as JaxBatch
from cultionet_tpu.models import CultioNet as JaxCultioNet
from cultionet_tpu.train import step as jax_step
from cultionet_tpu.train.fit import fit as jax_fit
from cultionet_tpu_torch.config import CultionetParams
from cultionet_tpu_torch.data.datasets import ChipDataset
from cultionet_tpu_torch.model import load_model
from cultionet_tpu_torch.models import CultioNet
from cultionet_tpu_torch.train.fit import fit
from cultionet_tpu_torch.utils.params import from_flax, load_flax

from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    one_torch_thread,
    seeded_variables,
    write_chip_files,
)

MODEL = dict(hidden_channels=4, dilations=[1], attention_weights=None)
CONFIG = dict(
    val_frac=0.25,
    batch_size=4,
    epochs=2,
    learning_rate=1e-3,
    lr_scheduler="ExponentialLR",
    loss_name="TanimotoComplementLoss",
    precision="32",
    dropout=0.0,
    finetune="all",
    in_channels=3,
    in_time=6,
    devices=2,
    **MODEL,
)


@pytest.fixture(scope="module")
def chips(tmp_path_factory):
    root = tmp_path_factory.mktemp("chips")
    write_chip_files(root, num=12, seed=100, packed=False, size=16)
    return root


@pytest.fixture(scope="module")
def weights():
    jax_model = JaxCultioNet(in_time=6, dropout=0.0, **MODEL)
    variables = seeded_variables(
        jax_model, JaxBatch(x=jnp.zeros((1, 6, 16, 16, 3))), training=False,
        seed=3,
    )
    return jax_model, variables


def _port_fit(chips, ckpt_dir, weights, **overrides):
    _, variables = weights
    model = load_flax(CultioNet(in_time=6, dropout=0.0, **MODEL), variables)
    return fit(
        CultionetParams(
            ckpt_file=ckpt_dir / "last.ckpt",
            dataset=ChipDataset(chips),
            **{**CONFIG, **overrides},
        ),
        pretrained_state=model.state_dict(),
        device="cpu",
    )


@pytest.fixture(scope="module")
def plain(chips, weights, tmp_path_factory):
    """The uninterrupted 2-epoch run on two ranks."""
    ckpt = tmp_path_factory.mktemp("plain")
    return ckpt, _port_fit(chips, ckpt, weights)


def _check_weights(got: dict, want: dict, rel: float) -> None:
    top = max(float(v.abs().max()) for v in want.values())
    for name, value in want.items():
        diff = float((got[name].float() - value.float()).abs().max())
        assert diff <= rel * top, (name, diff, top)


def test_fit_on_two_ranks_matches_jax(chips, weights, plain, tmp_path):
    jax_model, variables = weights
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
            load_batch_workers=0,
            **CONFIG,
        ),
        pretrained_state=pretrained,
    )
    ckpt, got = plain
    assert len(got.history) == len(want.history) == 2
    for port_row, jax_row in zip(got.history, want.history):
        for key in ("loss", "val_loss", "val_score", "lr_sch"):
            np.testing.assert_allclose(
                port_row[key], jax_row[key], atol=1e-4, rtol=0, err_msg=key
            )
    want_state = from_flax(
        {"params": want.state.params, "batch_stats": want.state.batch_stats}
    )
    state = got.state.model.state_dict()
    _check_weights(state, want_state, 1e-4)
    assert got.state.step == 4 and got.state.optimizer.count == 4

    _, loaded = load_model(ckpt / "last_store", which="last", device="cpu")
    for name, value in loaded.state_dict().items():
        assert torch.equal(value, state[name]), name


def test_batch_size_must_divide_over_devices(chips, weights, tmp_path):
    with pytest.raises(ValueError, match="divide evenly over 2 devices"):
        _port_fit(chips, tmp_path, weights, batch_size=3)
