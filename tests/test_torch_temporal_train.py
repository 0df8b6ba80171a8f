"""The port's train step with the transformer temporal front end, on the
CPU: two fp32 steps against the JAX step (losses 1e-5; gradients, with
``pool_query``'s, 1e-4 of the largest entry; parameters and running
statistics 1e-5, as ``test_torch_train.py::test_train_step_matches_jax``),
and a bf16 "16-mixed" step at dropout 0.2 drawn from the step's generator.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cultionet_tpu.data.batch import Batch as JaxBatch
from cultionet_tpu.train import optim as jax_optim
from cultionet_tpu.train import step as jax_step
from cultionet_tpu_torch.data.synthetic import create_batch
from cultionet_tpu_torch.models import CultioNet
from cultionet_tpu_torch.train import optim as torch_optim
from cultionet_tpu_torch.train import step as torch_step
from cultionet_tpu_torch.utils.params import from_flax, load_flax

from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    jax_transformer_model,
    one_torch_thread,
    port_transformer_model,
)

LOSS = "TanimotoComplementLoss"


def test_train_steps_match_jax():
    """Two fp32 dropout-0 steps of the transformer config against the JAX
    step (hidden 8, T = 6, 2 x 44 x 44), with SGD (momentum 0.9, no weight
    decay, lr 1) in both packages: the JAX step's first update is then
    minus the gradient, so its gradients (pool_query's included) come out
    of the same compiled step, to the rounding of the parameters (a smaller
    lr divides that rounding by lr). The CLI optimizer itself is held to
    optax in test_torch_train.py."""
    lr = 1.0
    jax_model, variables = jax_transformer_model(8, dropout=0.0, seed=3)
    batch = create_batch(
        num_channels=3, num_time=6, height=44, width=44, batch_size=2,
        rng=np.random.default_rng(5),
    )
    jax_batch = JaxBatch(
        x=jnp.asarray(batch.x.numpy()),
        y=jnp.asarray(batch.y.numpy()),
        bdist=jnp.asarray(batch.bdist.numpy()),
    )
    model = load_flax(port_transformer_model(8, dropout=0.0), variables)

    grad_model = copy.deepcopy(model)
    loss, _ = torch_step.forward_loss(
        grad_model, batch, torch.Generator(), loss_name=LOSS
    )
    loss.backward()
    got_grads = {n: p.grad for n, p in grad_model.named_parameters()}

    def sgd(module):
        return module.build_optimizer(
            "SGD", learning_rate=lr, weight_decay=0.0
        )

    state = jax_step.TrainState.create(
        apply_fn=jax_model.apply,
        params=variables["params"],
        batch_stats=variables["batch_stats"],
        tx=sgd(jax_optim),
    )
    jax_train = jax_step.make_train_step(loss_name=LOSS, donate=False)
    torch_state = torch_step.create_train_state(
        copy.deepcopy(model), sgd(torch_optim), device="cpu"
    )
    torch_train = torch_step.make_train_step(loss_name=LOSS, device="cpu")
    key = jax.random.PRNGKey(0)
    generator = torch.Generator().manual_seed(0)
    for step in range(2):
        before = state.params
        state, want_logs = jax_train(state, jax_batch, key)
        if step == 0:
            want_grads = from_flax({"params": jax.tree_util.tree_map(
                lambda a, b: (np.asarray(a) - np.asarray(b)) / lr,
                before, state.params,
            )})
        torch_state, logs = torch_train(torch_state, batch, generator)
        for name in ("loss", "dloss", "eloss", "closs"):
            np.testing.assert_allclose(
                float(logs[name]), float(want_logs[name]), atol=1e-5,
                err_msg=name,
            )

    assert set(got_grads) == set(want_grads)
    assert float(got_grads["mask_model.pre_unet.pool_query"].abs().max()) > 0
    top = max(float(g.abs().max()) for g in want_grads.values())
    for name, ref in want_grads.items():
        diff = float((got_grads[name] - ref).abs().max())
        assert diff <= 1e-4 * top, (name, diff, top)
    want = from_flax({"params": state.params, "batch_stats": state.batch_stats})
    got = torch_state.model.state_dict()
    for name, value in want.items():
        np.testing.assert_allclose(
            got[name].numpy(), value.numpy(), atol=1e-5, err_msg=name
        )


def test_bf16_train_step_lowers_the_loss_with_dropout():
    """The transformer config's "16-mixed" step at dropout 0.2 on a tiny
    model: the loss falls over 6 steps on one batch; one generator seed
    gives one result, another seed another, and torch's global RNG is
    untouched."""
    batch = create_batch(
        num_channels=3, num_time=6, height=24, width=24, batch_size=2,
        rng=np.random.default_rng(42),
    )

    def run(seed, steps):
        model = CultioNet(
            in_time=6, hidden_channels=8, dropout=0.2,
            temporal_encoder="transformer",
        )
        tx = torch_optim.build_optimizer("AdamW", learning_rate=1e-3)
        state = torch_step.create_train_state(model, tx, seed=0, device="cpu")
        step = torch_step.make_train_step(
            loss_name=LOSS, precision="16-mixed", device="cpu"
        )
        generator = torch.Generator().manual_seed(seed)
        rng_state = torch.get_rng_state()
        losses = [
            float(step(state, batch, generator)[1]["loss"])
            for _ in range(steps)
        ]
        assert torch.equal(torch.get_rng_state(), rng_state)
        return losses

    losses = run(0, 6)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    assert run(0, 2) == losses[:2]
    assert run(1, 1) != losses[:1]
