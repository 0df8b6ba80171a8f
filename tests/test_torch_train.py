"""The port's training path against the JAX package, fp32 on the CPU:
BatchNorm's training update, the schedules and the optimizer, and the train
and eval steps from translated weights (hidden 8, T = 6, 2 x 44 x 44,
dropout 0).

Tolerances: BatchNorm statistics 1e-6 (one fp32 reduction in another
order); schedules 1e-5 relative (optax evaluates them in fp32, the port in
double); optimizer parameters 1e-6; losses 1e-5; parameters and running
statistics 1e-5 after two steps (a random-init network amplifies fp32
round-off, ROADMAP.md "conditioning note"). Gradients: within 1e-4 of the
largest gradient entry, and within 1e-3 of each tensor's own largest entry
(a bias gradient sums a whole map of nearly cancelling terms; the worst,
final_c.dist_conv's, differs by 2.3e-4 of its own scale through fp32
summation order alone).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cultionet_tpu.data.batch import Batch as JaxBatch
from cultionet_tpu.models import CultioNet as JaxCultioNet
from cultionet_tpu.nn.blocks import BatchNorm as JaxBatchNorm
from cultionet_tpu.train import optim as jax_optim
from cultionet_tpu.train import step as jax_step
from cultionet_tpu.train.precision import cast_floating as jax_cast
from cultionet_tpu_torch.data.synthetic import create_batch
from cultionet_tpu_torch.models import CultioNet
from cultionet_tpu_torch.nn.blocks import BatchNorm
from cultionet_tpu_torch.train import optim as torch_optim
from cultionet_tpu_torch.train import step as torch_step
from cultionet_tpu_torch.utils.params import from_flax, load_flax

from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    one_torch_thread,
    seeded_variables,
)

LOSS = "TanimotoComplementLoss"


def _flax_bn(x_nhwc, variables, dtype):
    """One training call of the JAX BatchNorm with its variables cast to
    ``dtype``, as the JAX step casts them; returns (out, new stats)."""
    out, mutated = JaxBatchNorm().apply(
        jax_cast(jax.tree_util.tree_map(jnp.asarray, variables), dtype),
        jnp.asarray(x_nhwc).astype(dtype),
        training=True,
        mutable=["batch_stats"],
    )
    stats = mutated["batch_stats"]["BatchNorm_0"]
    return np.asarray(out.astype(jnp.float32)), stats


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_training_update_matches_flax(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 5, 4)).astype("float32") * 2.0 + 0.5
    variables = {
        "params": {
            "BatchNorm_0": {
                "scale": rng.uniform(0.8, 1.2, 4).astype("float32"),
                "bias": rng.normal(size=4).astype("float32"),
            }
        },
        "batch_stats": {
            "BatchNorm_0": {
                "mean": (0.1 * rng.normal(size=4)).astype("float32"),
                "var": rng.uniform(1.0, 2.0, 4).astype("float32"),
            }
        },
    }
    want_out, want = _flax_bn(x, variables, getattr(jnp, dtype))

    bn = BatchNorm(4)
    load_flax(bn, variables).train()
    compute = getattr(torch, dtype)
    params = {n: p.to(compute) for n, p in bn.named_parameters()}
    x_nchw = torch.from_numpy(x).permute(0, 3, 1, 2).to(compute)
    with torch.no_grad():
        out = torch.func.functional_call(bn, params, (x_nchw,))
    inner = bn.BatchNorm_0
    assert inner.running_mean.dtype == torch.float32
    np.testing.assert_allclose(
        inner.running_mean.numpy(), np.asarray(want["mean"]), atol=1e-6
    )
    np.testing.assert_allclose(
        inner.running_var.numpy(), np.asarray(want["var"]), atol=1e-6
    )
    np.testing.assert_allclose(
        out.float().permute(0, 2, 3, 1).numpy(),
        want_out,
        atol=1e-5 if dtype == "float32" else 2e-2,
    )


@pytest.mark.parametrize(
    "name,epochs,steps_per_epoch",
    [
        ("OneCycleLR", 4, 9),
        ("OneCycleLR", 1, 5),  # a horizon under 10 steps
        ("CosineAnnealingLR", 3, 4),
        ("ExponentialLR", 3, 4),
        ("StepLR", 12, 1),
    ],
)
def test_schedules_match_optax(name, epochs, steps_per_epoch):
    want = jax_optim.build_schedule(name, 0.01, epochs, steps_per_epoch)
    got = torch_optim.build_schedule(name, 0.01, epochs, steps_per_epoch)
    total = max(epochs * steps_per_epoch, 10)
    steps = range(total + 3)
    np.testing.assert_allclose(
        [got(s) for s in steps], [float(want(s)) for s in steps], rtol=1e-5
    )
    want_b1 = jax_optim.build_momentum_schedule(name, epochs, steps_per_epoch)
    got_b1 = torch_optim.build_momentum_schedule(name, epochs, steps_per_epoch)
    if want_b1 is None:
        assert got_b1 is None
    else:
        np.testing.assert_allclose(
            [got_b1(s) for s in steps],
            [float(want_b1(s)) for s in steps],
            rtol=1e-5,
        )


@pytest.mark.parametrize(
    "optimizer,clip,algorithm,accumulate",
    [
        ("AdamW", 0.5, "norm", 1),
        ("AdamW", 0.05, "value", 1),
        ("AdamW", 1.0, "norm", 2),
        ("Adam", None, "norm", 1),
        ("SGD", 0.5, "norm", 1),
    ],
)
def test_optimizer_matches_optax(optimizer, clip, algorithm, accumulate):
    rng = np.random.default_rng(1)
    params = {
        "w": rng.normal(size=(3, 4)).astype("float32"),
        "b": rng.normal(size=(4,)).astype("float32"),
    }
    kwargs = dict(
        optimizer=optimizer,
        weight_decay=1e-2,
        eps=1e-4,
        gradient_clip_val=clip,
        gradient_clip_algorithm=algorithm,
        accumulate_grad_batches=accumulate,
    )
    schedules = dict(
        learning_rate=("OneCycleLR", 0.05, 1, 3),
        b1_schedule=("OneCycleLR", 1, 3) if optimizer == "AdamW" else None,
    )
    tx = jax_optim.build_optimizer(
        learning_rate=jax_optim.build_schedule(*schedules["learning_rate"]),
        b1_schedule=schedules["b1_schedule"]
        and jax_optim.build_momentum_schedule(*schedules["b1_schedule"]),
        **kwargs,
    )
    spec = torch_optim.build_optimizer(
        learning_rate=torch_optim.build_schedule(*schedules["learning_rate"]),
        b1_schedule=schedules["b1_schedule"]
        and torch_optim.build_momentum_schedule(*schedules["b1_schedule"]),
        **kwargs,
    )
    jax_params = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jax_params)
    torch_params = {
        k: torch.tensor(v, requires_grad=True) for k, v in params.items()
    }
    opt = spec.init(torch_params.values())
    for _ in range(3 * accumulate):
        grads = {
            k: rng.normal(size=v.shape).astype("float32")
            for k, v in params.items()
        }
        updates, opt_state = tx.update(
            {k: jnp.asarray(v) for k, v in grads.items()},
            opt_state,
            jax_params,
        )
        jax_params = optax.apply_updates(jax_params, updates)
        for k, p in torch_params.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        for k in params:
            np.testing.assert_allclose(
                torch_params[k].detach().numpy(),
                np.asarray(jax_params[k]),
                atol=1e-6,
                err_msg=k,
            )
    assert opt.count == 3


def _cli_optimizers(epochs=2, steps_per_epoch=3):
    """The CLI-default optimizer (AdamW, OneCycle peak 0.01 with the beta1
    cycle, weight decay 1e-3, global-norm clip 1.0) in both packages."""

    def build(module):
        return module.build_optimizer(
            optimizer="AdamW",
            learning_rate=module.build_schedule(
                "OneCycleLR", 0.01, epochs, steps_per_epoch
            ),
            weight_decay=1e-3,
            eps=1e-4,
            gradient_clip_val=1.0,
            b1_schedule=module.build_momentum_schedule(
                "OneCycleLR", epochs, steps_per_epoch
            ),
        )

    return build(jax_optim), build(torch_optim)


@pytest.fixture(scope="module")
def setup():
    jax_model = JaxCultioNet(
        in_time=6, hidden_channels=8, dilations=[1, 2], dropout=0.0
    )
    variables = seeded_variables(
        jax_model,
        JaxBatch(x=jnp.zeros((1, 6, 44, 44, 3))),
        training=False,
        seed=3,
    )
    batch = create_batch(
        num_channels=3, num_time=6, height=44, width=44, batch_size=2,
        rng=np.random.default_rng(5),
    )
    jax_batch = JaxBatch(
        x=jnp.asarray(batch.x.numpy()),
        y=jnp.asarray(batch.y.numpy()),
        bdist=jnp.asarray(batch.bdist.numpy()),
    )
    model = load_flax(
        CultioNet(in_time=6, hidden_channels=8, dilations=[1, 2], dropout=0.0),
        variables,
    )
    return jax_model, variables, jax_batch, model, batch


def _check_grads(got: dict, want: dict) -> None:
    top = max(float(ref.abs().max()) for ref in want.values())
    assert set(got) == set(want)
    for name, ref in want.items():
        diff = float((got[name] - ref).abs().max())
        assert diff <= 1e-4 * top, (name, diff, top)
        assert diff <= 1e-3 * float(ref.abs().max()), (name, diff)


def _check_initial_grads(jax_model, variables, jax_batch, model, batch):
    key = jax.random.PRNGKey(0)

    def loss_fn(params, stats):
        outputs, _ = jax_model.apply(
            {"params": params, "batch_stats": stats},
            jax_batch,
            training=True,
            mutable=["batch_stats"],
            rngs={"dropout": key},
        )
        loss, _ = jax_step.calc_loss(outputs, jax_batch, loss_name=LOSS)
        return loss

    jax_grads = jax.jit(jax.grad(loss_fn))(
        variables["params"], variables["batch_stats"]
    )
    grad_model = copy.deepcopy(model)
    loss, _ = torch_step.forward_loss(
        grad_model, batch, torch.Generator(), loss_name=LOSS
    )
    loss.backward()
    got_grads = {n: p.grad for n, p in grad_model.named_parameters()}
    _check_grads(got_grads, from_flax({"params": jax_grads}))


@pytest.mark.parametrize("weighted", [False, True])
def test_train_step_matches_jax(setup, weighted):
    jax_model, variables, jax_batch, model, batch = setup
    weights = (
        torch_step.class_weights_from_counts([900, 100], [990, 10])
        if weighted
        else None
    )
    jax_tx, torch_tx = _cli_optimizers()
    key = jax.random.PRNGKey(0)
    if not weighted:
        # Gradients once (the weighted case differs only in the loss mask,
        # which its parameters after two steps check).
        _check_initial_grads(jax_model, variables, jax_batch, model, batch)

    state = jax_step.TrainState.create(
        apply_fn=jax_model.apply,
        params=variables["params"],
        batch_stats=variables["batch_stats"],
        tx=jax_tx,
    )
    jax_train = jax_step.make_train_step(
        loss_name=LOSS, donate=False, class_weights=weights
    )
    torch_state = torch_step.create_train_state(
        copy.deepcopy(model), torch_tx, device="cpu"
    )
    torch_train = torch_step.make_train_step(
        loss_name=LOSS, class_weights=weights, device="cpu"
    )
    generator = torch.Generator().manual_seed(0)
    for _ in range(2):
        state, want_logs = jax_train(state, jax_batch, key)
        torch_state, logs = torch_train(torch_state, batch, generator)
        for name in ("loss", "dloss", "eloss", "closs"):
            np.testing.assert_allclose(
                float(logs[name]), float(want_logs[name]), atol=1e-5,
                err_msg=name,
            )
    assert torch_state.step == 2 and torch_state.optimizer.count == 2
    want = from_flax(
        {"params": state.params, "batch_stats": state.batch_stats}
    )
    got = torch_state.model.state_dict()
    for name, value in want.items():
        np.testing.assert_allclose(
            got[name].numpy(), value.numpy(), atol=1e-5, err_msg=name
        )


def test_eval_step_matches_jax(setup):
    jax_model, variables, jax_batch, model, batch = setup
    jax_tx, torch_tx = _cli_optimizers()
    state = jax_step.TrainState.create(
        apply_fn=jax_model.apply,
        params=variables["params"],
        batch_stats=variables["batch_stats"],
        tx=jax_tx,
    )
    want = jax_step.make_eval_step(loss_name=LOSS)(state, jax_batch)
    torch_state = torch_step.create_train_state(
        copy.deepcopy(model), torch_tx, device="cpu"
    )
    got = torch_step.make_eval_step(loss_name=LOSS, device="cpu")(
        torch_state, batch
    )
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(
            float(got[name]), float(want[name]), atol=1e-5, err_msg=name
        )


def test_bf16_train_step_lowers_the_loss_with_dropout():
    """The CLI-default step (16-mixed, dropout 0.2 with the attention
    dropout on the plain path) on a tiny model: the loss falls over 8 steps
    on one batch, as tests/test_train_step.py asks of the JAX step; one
    generator seed gives one result and torch's global RNG is untouched."""
    batch = create_batch(
        num_channels=3, num_time=6, height=24, width=24, batch_size=2,
        rng=np.random.default_rng(42),
    )

    def run(seed):
        model = CultioNet(in_time=6, hidden_channels=8, dropout=0.2)
        tx = torch_optim.build_optimizer("AdamW", learning_rate=1e-3)
        state = torch_step.create_train_state(model, tx, seed=0, device="cpu")
        step = torch_step.make_train_step(
            loss_name=LOSS, precision="16-mixed", device="cpu"
        )
        generator = torch.Generator().manual_seed(seed)
        rng_state = torch.get_rng_state()
        losses = [
            float(step(state, batch, generator)[1]["loss"]) for _ in range(8)
        ]
        assert torch.equal(torch.get_rng_state(), rng_state)
        return losses

    losses = run(0)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    assert run(0) == losses
    assert run(1) != losses


def test_entry_points_need_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = CultioNet(in_time=6, hidden_channels=8)
    tx = torch_optim.build_optimizer()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_step.make_train_step()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_step.make_eval_step()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_step.create_train_state(model, tx)
    state = torch_step.create_train_state(model, tx, device="cpu")
    step = torch_step.make_train_step(device="cpu")
    batch = create_batch(num_time=6, height=16, width=16)
    with pytest.raises(TypeError, match="Generator"):
        step(state, batch, None)
    # In-step augmentation and normalization run since the device data
    # path was ported (tests/test_torch_device_augment.py holds them).
    assert callable(
        torch_step.make_train_step(
            device="cpu", device_augment=True, norm_stats=([0.5], [0.2])
        )
    )
