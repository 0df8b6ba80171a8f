"""The port's data parallelism (``cultionet_tpu_torch/parallel/``) on two
CPU ranks over gloo, against the JAX package's mesh on two host devices
and against the port's single-process step at the whole batch.

One 2-rank group runs every port check (``torch_dp_ranks.py::
parallel_checks``), once for the module: hidden 4, NA with dilations
[1, 2], T = 5, 8 x 16 x 16 chips, fp32, dropout 0, AdamW (lr 1e-3, weight
decay 1e-3, global-norm clip 1.0 on the global gradient).

- the sharded train step (each rank its contiguous block of 4) against
  JAX's ``make_sharded_train_step`` on ``create_mesh(2)`` and against the
  port's single-process step on all 8: loss rtol 1e-5, parameters and
  running statistics rtol 1e-4 / atol 1e-6 (JAX's own tolerances,
  ``tests/test_parallel.py``); the sharded eval metrics likewise;
- the same with FSDP (``min_size`` 128, as JAX's test), with at least one
  parameter really sharded;
- the gradients each rank's optimizer receives, for both, against the
  single process's and JAX's (minus the first update of SGD at lr 1):
  rtol 1e-4 / atol 1e-6 (Adam's update and the clip cannot see a factor
  common to every gradient);
- BatchNorm's statistics, output and input gradient over the global batch
  against flax's ``BatchNorm`` on the whole batch (1e-5; the statistics
  1e-6);
- the registry's masked ratio losses (``log_cosh_loss``,
  ``class_balanced_mse_loss``, ``boundary_loss``): their value on the
  gathered outputs and the ranks' gradients against JAX's loss and
  gradient on the whole batch (1e-6 of the largest entry);
- ``shard_batch``'s blocks against JAX's ``P("data")`` shards, and
  ``process_local_selection`` against JAX's;
- the sharded predict step's gathered outputs against the single-process
  predict of the whole batch (1e-6), ``global_batch_from_local``'s batch,
  ``topology_summary``'s JAX keys;
- ``fit`` inside the group (a group launched outside ``fit``), with
  pruning and stochastic weight averaging (the BatchNorm refit over the
  global batch): each rank trains on its file stripe with half the
  batch, the ranks' histories are the same global numbers and their final
  weights the same.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cultionet_tpu.data.batch import Batch as JaxBatch
from cultionet_tpu.data.loader import (
    process_local_selection as jax_process_local_selection,
)
from cultionet_tpu.losses import losses as jax_losses
from cultionet_tpu.models import CultioNet as JaxCultioNet
from cultionet_tpu.nn.blocks import BatchNorm as JaxBatchNorm
from cultionet_tpu.parallel import (
    create_mesh,
    make_sharded_eval_step as jax_sharded_eval,
    make_sharded_train_step as jax_sharded_train,
    replicate_state as jax_replicate,
    shard_batch as jax_shard_batch,
)
from cultionet_tpu.train import optim as jax_optim
from cultionet_tpu.train import step as jax_step
from cultionet_tpu_torch.config import CultionetParams
from cultionet_tpu_torch.data.datasets import ChipDataset
from cultionet_tpu_torch.data.loader import process_local_selection
from cultionet_tpu_torch.data.synthetic import create_batch
from cultionet_tpu_torch.models import CultioNet
from cultionet_tpu_torch.parallel.distributed import launch
from cultionet_tpu_torch.train import optim
from cultionet_tpu_torch.train import step as torch_step
from cultionet_tpu_torch.utils.params import from_flax, load_flax

import torch_dp_ranks
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    one_torch_thread,
    seeded_variables,
    write_chip_files,
)

MODEL = dict(in_time=5, hidden_channels=4, dilations=[1], dropout=0.0,
             attention_weights=None)
TX = dict(optimizer="AdamW", learning_rate=1e-3, weight_decay=1e-3,
          gradient_clip_val=1.0)
LOSS = "TanimotoComplementLoss"


@pytest.fixture(scope="module")
def case(tmp_path_factory, one_torch_thread):
    """The JAX model's seeded variables, the batch, the BatchNorm and loss
    inputs, and the two ranks' results."""
    jax_model = JaxCultioNet(**MODEL)
    variables = seeded_variables(
        jax_model, JaxBatch(x=jnp.zeros((1, 5, 16, 16, 2))), training=False,
        seed=0,
    )
    batch = create_batch(
        num_channels=2, num_time=5, height=16, width=16, batch_size=8,
        rng=np.random.default_rng(0),
    )
    model = load_flax(CultioNet(in_channels=2, **MODEL), variables)

    rng = np.random.default_rng(1)
    bn_x = (rng.normal(size=(8, 6, 5, 5)) * 2.0 + 0.5).astype("float32")
    bn_probe = rng.normal(size=bn_x.shape).astype("float32")
    bn_vars = {
        "params": {"BatchNorm_0": {
            "scale": rng.uniform(0.8, 1.2, 6).astype("float32"),
            "bias": rng.normal(size=6).astype("float32"),
        }},
        "batch_stats": {"BatchNorm_0": {
            "mean": rng.normal(size=6).astype("float32"),
            "var": rng.uniform(1.0, 2.0, 6).astype("float32"),
        }},
    }
    bn_state = from_flax(bn_vars)
    bn_state["BatchNorm_0.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    preds = rng.random((8, 16, 16, 1)).astype("float32")
    bdist = rng.random((8, 16, 16)).astype("float32")
    mask = (rng.random((8, 16, 16)) > 0.3).astype("float32")

    chips = tmp_path_factory.mktemp("chips")
    write_chip_files(chips, num=10, seed=3, packed=False, size=16)
    fit_params = CultionetParams(
        dataset=ChipDataset(chips), val_frac=0.2, batch_size=4, epochs=1,
        learning_rate=1e-3, precision="32", dropout=0.0, in_channels=3,
        in_time=6, hidden_channels=4, dilations=[1],
        attention_weights=None, stochastic_weight_averaging=True,
        model_pruning=True,
    )
    payload = {
        "model_kwargs": dict(in_channels=2, **MODEL),
        "state_dict": model.state_dict(),
        "batch": {k: v for k, v in vars(batch).items()
                  if isinstance(v, torch.Tensor)},
        "tx": TX,
        "bn": {"bn_state": bn_state, "x_nchw": torch.from_numpy(bn_x),
               "probe": torch.from_numpy(bn_probe)},
        "ratio": {"preds": torch.from_numpy(preds),
                  "bdist": torch.from_numpy(bdist),
                  "mask": torch.from_numpy(mask)},
        "fit_params": fit_params,
    }
    out = tmp_path_factory.mktemp("ranks")
    launch(torch_dp_ranks.parallel_checks, 2, "cpu", args=(payload, str(out)))
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    return dict(
        jax_model=jax_model, variables=variables, batch=batch, model=model,
        ranks=ranks, bn_x=bn_x, bn_probe=bn_probe, bn_vars=bn_vars,
        preds=preds, bdist=bdist, mask=mask,
    )


def _jax_batch(batch):
    return JaxBatch(
        x=jnp.asarray(batch.x.numpy()),
        y=jnp.asarray(batch.y.numpy()),
        bdist=jnp.asarray(batch.bdist.numpy()),
    )


@pytest.fixture(scope="module")
def jax_sharded(case):
    """JAX's sharded step and eval on a 2-device mesh."""
    jax_model, variables = case["jax_model"], case["variables"]
    state = jax_step.TrainState.create(
        apply_fn=jax_model.apply,
        params=variables["params"],
        batch_stats=variables["batch_stats"],
        tx=jax_optim.build_optimizer(**TX),
    )
    mesh = create_mesh(2)
    batch = jax_shard_batch(_jax_batch(case["batch"]), mesh)
    new_state, logs = jax_sharded_train(mesh, loss_name=LOSS, precision="fp32")(
        jax_replicate(state, mesh), batch, jax.random.PRNGKey(0)
    )
    metrics = jax_sharded_eval(mesh, loss_name=LOSS, precision="fp32")(
        new_state, batch
    )
    # SGD at lr 1 without decay: the first update is minus the gradient.
    sgd_state = jax_step.TrainState.create(
        apply_fn=jax_model.apply,
        params=variables["params"],
        batch_stats=variables["batch_stats"],
        tx=jax_optim.build_optimizer("SGD", learning_rate=1.0, weight_decay=0.0),
    )
    stepped, _ = jax_sharded_train(mesh, loss_name=LOSS, precision="fp32")(
        jax_replicate(sgd_state, mesh), batch, jax.random.PRNGKey(0)
    )
    before = from_flax({"params": sgd_state.params})
    after = from_flax({"params": stepped.params})
    return {
        "loss": float(logs["loss"]),
        "state": from_flax(
            {"params": new_state.params, "batch_stats": new_state.batch_stats}
        ),
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": {
            n: before[n].double() - after[n].double() for n in before
        },
    }


@pytest.fixture(scope="module")
def single(case):
    """The port's single-process step and eval at the whole batch."""
    state = torch_step.create_train_state(
        copy.deepcopy(case["model"]), optim.build_optimizer(**TX),
        device="cpu",
    )
    kwargs = dict(loss_name=LOSS, precision="fp32", device="cpu")
    grads = torch_dp_ranks.keep_gradients(state)
    state, logs = torch_step.make_train_step(**kwargs)(
        state, case["batch"], torch.Generator()
    )
    metrics = torch_step.make_eval_step(**kwargs)(state, case["batch"])
    return {
        "loss": float(logs["loss"]),
        "state": state.model.state_dict(),
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": grads,
    }


def _check_state(got: dict, want: dict) -> None:
    for name, value in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(
            got[name].numpy(), value.numpy(), rtol=1e-4, atol=1e-6,
            err_msg=name,
        )


@pytest.mark.parametrize("mode", ["dp", "fsdp"])
@pytest.mark.parametrize("against", ["jax", "single"])
def test_sharded_step_matches(case, jax_sharded, single, mode, against):
    want = jax_sharded if against == "jax" else single
    for got in case["ranks"]:
        result = got[mode]
        np.testing.assert_allclose(result["loss"], want["loss"], rtol=1e-5)
        _check_state({**result["params"], **result["buffers"]}, want["state"])
        for key, value in want["metrics"].items():
            np.testing.assert_allclose(
                result["metrics"][key], value, rtol=1e-5, atol=1e-6,
                err_msg=key,
            )
        if mode == "fsdp":
            assert result["fsdp_modules"], "no submodule was sharded"
            assert result["sharded"], "no parameter was sharded"


@pytest.mark.parametrize("mode", ["dp", "fsdp"])
@pytest.mark.parametrize("against", ["jax", "single"])
def test_sharded_gradients_match(case, jax_sharded, single, mode, against):
    """The gradient each rank's optimizer receives (after the all-reduce,
    before the clip) is the whole batch's: Adam and the clip would hide a
    factor common to every gradient, so the gradients are held here."""
    want = jax_sharded if against == "jax" else single
    for got in case["ranks"]:
        grads = got[mode]["grads"]
        assert set(grads) == set(want["grads"])
        for name, value in want["grads"].items():
            np.testing.assert_allclose(
                grads[name].double().numpy(), value.double().numpy(),
                rtol=1e-4, atol=1e-6, err_msg=name,
            )


def test_batchnorm_statistics_are_global(case):
    x_nhwc = jnp.asarray(case["bn_x"].transpose(0, 2, 3, 1))
    probe = jnp.asarray(case["bn_probe"].transpose(0, 2, 3, 1))

    def run(x):
        return JaxBatchNorm().apply(
            jax.tree_util.tree_map(jnp.asarray, case["bn_vars"]), x,
            training=True, mutable=["batch_stats"],
        )

    out, mutated = jax.jit(run)(x_nhwc)
    grad = jax.jit(jax.grad(lambda x: jnp.sum(run(x)[0] * probe)))(x_nhwc)
    stats = mutated["batch_stats"]["BatchNorm_0"]
    for got in case["ranks"]:
        bn = got["bn"]
        np.testing.assert_allclose(
            bn["out"].numpy(), np.asarray(out).transpose(0, 3, 1, 2),
            atol=1e-5,
        )
        np.testing.assert_allclose(
            bn["grad"].numpy(), np.asarray(grad).transpose(0, 3, 1, 2),
            atol=1e-5,
        )
        np.testing.assert_allclose(
            bn["running_mean"].numpy(), np.asarray(stats["mean"]), atol=1e-6
        )
        np.testing.assert_allclose(
            bn["running_var"].numpy(), np.asarray(stats["var"]), atol=1e-6
        )


@pytest.mark.parametrize(
    "name", ["log_cosh_loss", "class_balanced_mse_loss", "boundary_loss"]
)
def test_ratio_losses_are_global(case, name):
    fn = getattr(jax_losses, name)
    mask = jnp.asarray(case["mask"])
    bdist = jnp.asarray(case["bdist"])
    preds = jnp.asarray(case["preds"])
    value, grad = jax.jit(
        jax.value_and_grad(lambda p: fn(p, bdist, mask=mask))
    )(preds)
    grad = np.asarray(grad)
    for got in case["ranks"]:
        result = got["ratio"][name]
        np.testing.assert_allclose(result["loss"], float(value), rtol=1e-5)
        diff = np.abs(result["grad"].numpy() - grad).max()
        assert diff <= 1e-6 * np.abs(grad).max(), (name, diff)


def test_shard_batch_blocks_match_jax(case):
    sharded = jax_shard_batch(_jax_batch(case["batch"]), create_mesh(2))
    shards = sorted(
        sharded.x.addressable_shards, key=lambda s: s.index[0].start or 0
    )
    for got in case["ranks"]:
        r = got["rank"]
        np.testing.assert_array_equal(
            got["block_x"].numpy(), np.asarray(shards[r].data)
        )
        np.testing.assert_array_equal(
            got["block_x"].numpy(), case["batch"].x.numpy()[4 * r : 4 * r + 4]
        )


def test_process_local_selection_matches_jax():
    for n, count in ((23, 4), (10, 2), (3, 4)):
        for p in range(count):
            np.testing.assert_array_equal(
                process_local_selection(n, p, count),
                jax_process_local_selection(n, p, count),
            )


def test_fit_in_an_external_group(case):
    """8 train chips: each rank's stripe of 4 at 2 chips a step (half of
    the global batch of 4) is 2 steps an epoch; every rank logs the same
    global losses."""
    results = [got["fit"] for got in case["ranks"]]
    for got in results:
        assert got["steps_per_epoch"] == 2
        assert got["step"] == 2
        for key in ("loss", "val_loss", "val_score"):
            assert np.isfinite(got["history"][0][key]), key
    assert results[0]["history"] == results[1]["history"]
    for name, value in results[0]["state"].items():
        assert torch.equal(value, results[1]["state"][name]), name


def test_sharded_predict_step_and_global_batch(case):
    step = torch_step.make_predict_step(case["model"], "fp32", "cpu")
    want = step(case["batch"].x)
    for got in case["ranks"]:
        for name, value in got["predict"].items():
            np.testing.assert_allclose(
                value.numpy(), want[name].numpy(), atol=1e-6, err_msg=name
            )
        assert torch.equal(got["global_x"], case["batch"].x)
        assert got["topology"] == {
            "process_index": got["rank"],
            "process_count": 2,
            "global_device_count": 2,
            "local_device_count": 1,
            "platform": "cpu",
        }
