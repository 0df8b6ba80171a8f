"""``convert_orbax.py``: JAX package checkpoints (orbax) converted into the
port's ``torch.save`` checkpoints.

- The two trained golden checkpoints (``tests/data/golden/ckpt``, conv;
  ``tests/data/golden_transformer/ckpt``): every converted tensor equals
  the orbax item restored on a template from orbax's own metadata (no
  ``Checkpointer`` of either package, which the converter goes through)
  and translated by ``from_flax``, the meta file is JAX's, and
  ``load_model`` on the converted store and the port's ``ScenePredictor``
  reproduce ``golden.tif`` on at least 99.9% of its pixels (fp32, the
  golden scene's 4 windows).
- A JAX checkpoint with an optimizer state (the CLI-default chain:
  global-norm clip, AdamW with the beta1 cycle, and optax.MultiSteps at
  k = 2 for the accumulation case), 3 updates with seeded gradients: the
  converted moments equal optax's ``mu`` and ``nu`` tensor for tensor in
  the port's layout, with the update count, the accumulation position and
  the accumulated gradients; an optax state with no counterpart raises,
  naming it.
- ``fit`` resumes from a converted ``last``: the restored optimizer holds
  the converted moments, and the run continues from the next epoch.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cultionet_tpu.data.batch import Batch as JaxBatch
from cultionet_tpu.models import CultioNet as JaxCultioNet
from cultionet_tpu.train import optim as jax_optim
from cultionet_tpu.train import step as jax_step
from cultionet_tpu.train.checkpoint import Checkpointer as JaxCheckpointer
from cultionet_tpu_torch.config import CultionetParams
from cultionet_tpu_torch.data.constant import SCALE_FACTOR
from cultionet_tpu_torch.data.datasets import ChipDataset
from cultionet_tpu_torch.data.tiny_tiff import read_tiff
from cultionet_tpu_torch.model import load_model
from cultionet_tpu_torch.models import CultioNet
from cultionet_tpu_torch.predict import ScenePredictor
from cultionet_tpu_torch.train.checkpoint import Checkpointer
from cultionet_tpu_torch.train.fit import fit
from cultionet_tpu_torch.train.optim import build_optimizer
from cultionet_tpu_torch.train.step import create_train_state
from cultionet_tpu_torch.utils.params import from_flax

from convert_orbax import convert, convert_opt_state
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    one_torch_thread,
    seeded_variables,
    write_chip_files,
)

DATA = Path(__file__).parent / "data"
MODEL = dict(in_time=6, hidden_channels=4, dilations=[1],
             attention_weights=None, dropout=0.0)


@pytest.fixture(scope="module", params=["golden", "golden_transformer"])
def converted(request, tmp_path_factory):
    name = request.param
    store = tmp_path_factory.mktemp(name) / "last_store"
    assert convert(DATA / name / "ckpt" / "last_store", store) == ["last"]
    return name, store


def _reference_restore(jax_store: Path) -> dict:
    """The orbax ``model`` item of ``last`` restored on a template of
    numpy zeros made from orbax's own metadata of the item: no model, no
    traced template and no ``Checkpointer`` of either package (the
    converter restores through ``cultionet_tpu``'s)."""
    import orbax.checkpoint as ocp

    item = (jax_store / "last" / "model").absolute()
    checkpointer = ocp.StandardCheckpointer()
    template = jax.tree_util.tree_map(
        lambda leaf: np.zeros(leaf.shape, leaf.dtype),
        checkpointer.metadata(item).item_metadata.tree,
    )
    return checkpointer.restore(item, template)


def test_converted_golden_equals_restore(converted):
    name, store = converted
    jax_store = DATA / name / "ckpt" / "last_store"
    state = _reference_restore(jax_store)
    want = from_flax(
        {"params": state["params"], "batch_stats": state["batch_stats"]}
    )
    payload = torch.load(store / "last" / "model.pt", weights_only=True)
    got = {**payload["params"], **payload["batch_stats"]}
    got = {k: v for k, v in got.items() if not k.endswith("num_batches_tracked")}
    assert set(got) == set(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    assert payload["step"] == int(np.asarray(state["step"]))
    assert json.loads((store / "last.meta.json").read_text()) == json.loads(
        (jax_store / "last.meta.json").read_text()
    )


def test_converted_golden_reproduces_raster(converted):
    name, store = converted
    _, model = load_model(store, which="last", device="cpu")
    golden, *_ = read_tiff(DATA / name / "golden.tif")
    with np.load(DATA / "golden" / "scene.npz", allow_pickle=False) as data:
        x = data["x"].astype(np.float32) / SCALE_FACTOR
    raster, _ = ScenePredictor(
        model, batch_size=4, precision="fp32", device="cpu"
    ).predict_scene(x, window_size=50, padding=10)
    packed = np.moveaxis(
        np.clip(raster * SCALE_FACTOR, 0, 65535).astype("uint16"), -1, 0
    )
    match = float(np.mean(packed == golden))
    assert match >= 0.999, f"pixel match {match:.5f} < 0.999"


@pytest.fixture(scope="module")
def jax_variables():
    model = JaxCultioNet(**MODEL)
    variables = seeded_variables(
        model, JaxBatch(x=jnp.zeros((1, 6, 16, 16, 3))), training=False,
        seed=0,
    )
    return model, variables


def _jax_checkpoint(root: Path, jax_variables, accumulate: int):
    """A JAX checkpoint of the small model after 3 optax updates with
    seeded gradients, its meta holding what ``fit`` writes."""
    model, variables = jax_variables
    tx = jax_optim.build_optimizer(
        optimizer="AdamW",
        learning_rate=jax_optim.build_schedule("OneCycleLR", 1e-3, 2, 2),
        weight_decay=1e-3,
        gradient_clip_val=1.0,
        accumulate_grad_batches=accumulate,
        b1_schedule=jax_optim.build_momentum_schedule("OneCycleLR", 2, 2),
    )
    state = jax_step.TrainState.create(
        apply_fn=model.apply,
        params=variables["params"],
        batch_stats=variables["batch_stats"],
        tx=tx,
    )
    update = jax.jit(lambda st, g: st.apply_gradients(grads=g))
    rng = np.random.default_rng(1)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.normal(size=p.shape), p.dtype),
            state.params,
        )
        state = update(state, grads)
    hyperparams = {**MODEL, "in_channels": 3, "edge_class": 2,
                   "loss_name": "TanimotoComplementLoss",
                   "log_transform": False, "normalized_input": False}
    JaxCheckpointer(root).save_last(state, 0, {"val_score": 1.0}, hyperparams)
    return state


@pytest.fixture(scope="module")
def jax_ckpts(jax_variables, tmp_path_factory):
    """The JAX checkpoints of the CLI-default chain without and with
    accumulation (k = 1, 2) and their optax states, by k."""
    root = tmp_path_factory.mktemp("jax_ckpts")
    return {
        k: (root / f"k{k}", _jax_checkpoint(root / f"k{k}", jax_variables, k))
        for k in (1, 2)
    }


def _inner_adam(opt_state):
    """optax's ScaleByAdamState in the CLI-default chain."""
    leaves = jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: hasattr(s, "mu") and hasattr(s, "nu")
    )
    return next(s for s in leaves if hasattr(s, "mu"))


@pytest.mark.parametrize("accumulate", [1, 2])
def test_converted_optimizer_moments_equal_optax(
    tmp_path, jax_ckpts, accumulate
):
    jax_store, state = jax_ckpts[accumulate]
    convert(jax_store, tmp_path / "port")
    saved = torch.load(tmp_path / "port" / "last" / "opt.pt",
                       weights_only=True)["opt_state"]
    names = [n for n, _ in CultioNet(in_channels=3, **MODEL).named_parameters()]
    adam = _inner_adam(state.opt_state)
    mu = from_flax({"params": adam.mu})
    nu = from_flax({"params": adam.nu})
    slots = saved["torch_optimizer"]["state"]
    assert len(slots) == len(names)
    for i, name in enumerate(names):
        assert torch.equal(slots[i]["exp_avg"], mu[name]), name
        assert torch.equal(slots[i]["exp_avg_sq"], nu[name]), name
        assert float(slots[i]["step"]) == int(adam.count)
    assert saved["count"] == int(adam.count)
    if accumulate == 1:
        assert saved["count"] == 3 and saved["acc"] is None
    else:
        # Three mini-steps of two: one update, the next one half done.
        assert saved["count"] == 1 and saved["mini_step"] == 1
        acc = from_flax({"params": state.opt_state.acc_grads})
        for a, name in zip(saved["acc"], names):
            assert torch.equal(a, acc[name]), name


def test_unknown_optax_state_raises(jax_variables):
    """Lion's state (``mu`` without ``nu``) as orbax restores it: nested
    dicts by field name."""
    from flax import serialization

    _, variables = jax_variables
    lion = optax.scale_by_lion().init(variables["params"])
    raw = {"opt_state": serialization.to_state_dict(lion)}
    model = CultioNet(in_channels=3, **MODEL)
    with pytest.raises(ValueError, match="no counterpart in the port: .*/mu"):
        convert_opt_state(raw, model)


def test_fit_resumes_from_converted_last(tmp_path, jax_ckpts):
    ckpt = tmp_path / "ckpt"
    convert(jax_ckpts[1][0], ckpt / "last_store")
    saved = torch.load(ckpt / "last_store" / "last" / "opt.pt",
                       weights_only=True)["opt_state"]
    model = CultioNet(in_channels=3, **MODEL)
    state = create_train_state(model, build_optimizer("AdamW"), device="cpu")
    state = Checkpointer(ckpt / "last_store").restore(state, "last")
    assert state.optimizer.count == 3
    torch_state = state.optimizer.torch_optimizer.state_dict()["state"]
    for i, slot in saved["torch_optimizer"]["state"].items():
        assert torch.equal(torch_state[i]["exp_avg"], slot["exp_avg"])
        assert torch.equal(torch_state[i]["exp_avg_sq"], slot["exp_avg_sq"])

    write_chip_files(tmp_path / "chips", num=6, seed=2, packed=False, size=16)
    params = CultionetParams(
        ckpt_file=ckpt / "last.ckpt", dataset=ChipDataset(tmp_path / "chips"),
        val_frac=0.34, batch_size=2, epochs=2, learning_rate=1e-3,
        precision="32", in_channels=3, **MODEL,
    )
    got = fit(params, device="cpu")
    assert [row["epoch"] for row in got.history] == [1]
    assert got.state.optimizer.count == 3 + 2
    assert np.isfinite(got.history[0]["loss"])
