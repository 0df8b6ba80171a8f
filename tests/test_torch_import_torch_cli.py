"""The port's ``import-torch`` command (``scripts/cli.py::import_torch``)
against the JAX package's, on Lightning-shaped checkpoints written by
``torch_reference_keys.py`` from the CLI-default model at hidden 8, T = 6.

- JAX's ``import-torch`` (in process) and the port's (``device="cpu"``) on
  the same ``last.ckpt``, with and without ``hyper_parameters`` (then from
  the model flags): ``best`` and ``last`` at epoch 0 with JAX's
  hyperparameters, the command archived, and the two stores'
  ``load_model`` + fp32 predict on one seeded batch within 1e-5.
- A checkpoint with an entry of the wrong shape fails the import, naming
  the entry, and writes no store; without a card the command refuses to
  run on the CPU unasked.
- ``train-transfer --finetune fc`` from an imported store trains the heads
  only: every other weight stays the imported one, bit for bit.
"""

import json
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from cultionet_tpu.scripts import cli as jax_cli
from cultionet_tpu_torch.data.synthetic import create_batch
from cultionet_tpu_torch.models import CultioNet
from cultionet_tpu_torch.scripts import cli

from test_torch_import_torch import (
    HYPER,
    MODEL,
    OUTPUTS,
    build_case,
    jax_batch,
)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_reference_keys import lightning_checkpoint

FLAGS = ["--in-channels", "3", "--in-time", "6", "--hidden-channels", "8",
         "--dropout", "0.0", "--dilations", "1", "2"]


@pytest.fixture(scope="module")
def default_case():
    return build_case({})


def run_jax_cli(argv):
    with mock.patch.object(sys, "argv", ["cultionet-tpu"] + list(argv)):
        jax_cli.main()


@pytest.fixture(scope="module")
def jax_predict_step():
    """One JAX predict step for both CLI cases (the same model, one
    compilation)."""
    from cultionet_tpu.train.step import make_predict_step

    return make_predict_step(precision="fp32")


@pytest.mark.parametrize("with_hyper", [True, False])
def test_cli_import_matches_jax(default_case, jax_predict_step, tmp_path, with_hyper):
    from cultionet_tpu.model import load_model as jax_load_model
    from cultionet_tpu_torch.model import checkpoint_hyperparams, load_model
    from cultionet_tpu_torch.train.step import make_predict_step

    ckpt = lightning_checkpoint(
        default_case["source"].state_dict(), HYPER if with_hyper else None
    )
    ckpt_path = tmp_path / "last.ckpt"
    torch.save(ckpt, ckpt_path)
    flags = [] if with_hyper else FLAGS
    port_project, jax_project = tmp_path / "port", tmp_path / "jax"
    cli.main(["import-torch", "-p", str(port_project), "--torch-ckpt",
              str(ckpt_path), *flags], device="cpu")
    run_jax_cli(["import-torch", "-p", str(jax_project), "--torch-ckpt",
                 str(ckpt_path), *flags])

    store = port_project / "ckpt" / "last_store"
    for which in ("best", "last"):
        assert (store / which / "model.pt").is_file()
        meta = json.loads((store / f"{which}.meta.json").read_text())
        jax_meta = json.loads(
            (jax_project / "ckpt" / "last_store" / f"{which}.meta.json").read_text()
        )
        assert meta["epoch"] == jax_meta["epoch"] == 0
        assert meta["metrics"] == jax_meta["metrics"] == {}
        assert meta["hyperparams"] == jax_meta["hyperparams"]
    assert checkpoint_hyperparams(store) == HYPER
    archived = sorted((port_project / "commands").glob("import-torch_*.json"))
    assert len(archived) == 1

    jax_state, _ = jax_load_model(jax_project / "ckpt" / "last_store")
    _, model = load_model(store, device="cpu")
    batch = create_batch(
        num_channels=3, num_time=6, height=32, width=32, batch_size=2,
        rng=np.random.default_rng(3),
    )
    want = jax_predict_step(jax_state, jax_batch(batch))
    got = make_predict_step(model, "fp32", torch.device("cpu"))(batch.x, None, None)
    for name in OUTPUTS:
        np.testing.assert_allclose(
            got[name].numpy(), np.asarray(want[name]), rtol=0, atol=1e-5,
            err_msg=name,
        )


def test_cli_import_refuses_a_bad_checkpoint(default_case, tmp_path):
    state = default_case["source"].state_dict()
    ckpt = lightning_checkpoint(state, HYPER)
    key = next(k for k in ckpt["state_dict"] if k.endswith("skip.weight"))
    ckpt["state_dict"][key] = ckpt["state_dict"][key][:1]
    torch.save(ckpt, tmp_path / "bad.ckpt")
    with pytest.raises(ValueError, match="shape mismatch") as err:
        cli.main(["import-torch", "-p", str(tmp_path / "p"), "--torch-ckpt",
                  str(tmp_path / "bad.ckpt")], device="cpu")
    assert "skip/kernel" in str(err.value)
    assert not (tmp_path / "p" / "ckpt" / "last_store" / "last").exists()


def test_cli_import_needs_a_card_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["import-torch", "-p", str(tmp_path), "--torch-ckpt", "x.ckpt"])


def test_train_transfer_from_the_imported_store(tmp_path):
    """``train-transfer --finetune fc`` from an imported store trains the
    heads only: every other weight is the imported one."""
    from test_cli import make_project

    project = make_project(tmp_path, num_regions=3)
    cli.main(["create", "-p", str(project), "--num-workers", "1"], device="cpu")
    torch.manual_seed(5)
    source = CultioNet(in_channels=2, **MODEL)
    ckpt = lightning_checkpoint(source.state_dict(), {**HYPER, "in_channels": 2})
    torch.save(ckpt, tmp_path / "last.ckpt")
    cli.main(["import-torch", "-p", str(project), "--torch-ckpt",
              str(tmp_path / "last.ckpt")], device="cpu")
    cli.main(["train-transfer", "-p", str(project), "--epochs", "1",
              "--hidden-channels", "8", "--batch-size", "1", "--val-frac",
              "0.34", "--precision", "32", "--finetune", "fc"], device="cpu")
    transferred = torch.load(
        project / "ckpt" / "last_transfer_store" / "last" / "model.pt",
        weights_only=True,
    )["params"]
    imported = dict(source.named_parameters())
    assert set(transferred) == set(imported)
    heads = [n for n in imported if any(p.startswith("final_") for p in n.split("."))]
    assert heads
    for name, value in transferred.items():
        if name not in heads:
            assert torch.equal(value, imported[name].detach()), name
    assert any(not torch.equal(transferred[n], imported[n].detach()) for n in heads)
