"""Rematerialization (``remat=True``, ``cultionet_tpu_torch/nn/remat.py``)
on the CPU, port only (hidden 8, T = 6, 2 x 32 x 32, NA on its plain
path): the encoder, the decoder and the fusion run under
``torch.utils.checkpoint`` in a training forward with autograd on.

- The remat step equals the plain step at dropout 0.2, in fp32 and bf16:
  losses, gradients, parameters after the optimizer step, running
  statistics and the dropout generator's state after the step, bit for
  bit (the recompute replays the segment's generator state).
- The checkpointed BatchNorms run twice and update their statistics once.
- The backward, with its recompute, runs where no generator is in scope
  (a fresh ``contextvars`` context, as autograd's worker thread on CUDA
  sees it).
- Eval forwards and forwards without autograd never checkpoint.
"""

import contextvars
import copy

import numpy as np
import pytest
import torch

from cultionet_tpu_torch.data.synthetic import create_batch
from cultionet_tpu_torch.models import CultioNet
from cultionet_tpu_torch.models import tower_unet
from cultionet_tpu_torch.nn.blocks import BatchNorm
from cultionet_tpu_torch.nn.dropout import dropout_rng
from cultionet_tpu_torch.nn.init import init_parameters_
from cultionet_tpu_torch.train import optim as torch_optim
from cultionet_tpu_torch.train import step as torch_step

LOSS = "TanimotoComplementLoss"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def base():
    model = CultioNet(
        in_time=6, in_channels=3, hidden_channels=8, dilations=[1, 2],
        dropout=0.2,
    )
    init_parameters_(model, torch.Generator().manual_seed(0))
    batch = create_batch(
        num_channels=3, num_time=6, height=32, width=32, batch_size=2,
        rng=np.random.default_rng(0),
    )
    return model, batch


def with_remat(model, remat: bool):
    model = copy.deepcopy(model)
    model.mask_model.remat = remat
    return model


def run_step(model, batch, precision: str):
    """One train step; returns the logs, the gradients, the model's state
    after the update and the generator's state after the step."""
    state = torch_step.create_train_state(
        model, torch_optim.build_optimizer("AdamW", 1e-3), device="cpu"
    )
    grads = {}
    for name, param in state.model.named_parameters():
        param.register_post_accumulate_grad_hook(
            lambda p, name=name: grads.__setitem__(name, p.grad.clone())
        )
    step = torch_step.make_train_step(
        loss_name=LOSS, precision=precision, device="cpu"
    )
    generator = torch.Generator().manual_seed(7)
    _, logs = step(state, batch, generator)
    return logs, grads, state.model.state_dict(), generator.get_state()


@pytest.mark.parametrize("precision", ["fp32", "16-mixed"])
def test_remat_step_equals_plain_step(base, precision):
    model, batch = base
    want = run_step(with_remat(model, False), batch, precision)
    got = run_step(with_remat(model, True), batch, precision)
    for name in ("loss", "dloss", "eloss", "closs"):
        assert torch.equal(got[0][name], want[0][name]), name
    assert set(got[1]) == set(want[1]) and len(want[1]) > 0
    for part in (1, 2):
        for name, value in want[part].items():
            assert torch.equal(got[part][name], value), name
    assert torch.equal(got[3], want[3])


def test_running_statistics_update_once(base):
    """Each BatchNorm of the three segments runs in the forward and again
    in the recompute; the statistics equal the plain step's, which runs it
    once."""
    model, batch = base
    results = {}
    for remat in (False, True):
        m = with_remat(model, remat)
        calls = {}
        for name, module in m.named_modules():
            if isinstance(module, BatchNorm):
                module.register_forward_hook(
                    lambda *_, name=name: calls.__setitem__(
                        name, calls.get(name, 0) + 1
                    )
                )
        loss, _ = torch_step.forward_loss(
            m, batch, torch.Generator().manual_seed(1), loss_name=LOSS
        )
        loss.backward()
        results[remat] = calls, m.state_dict()
    plain_calls, plain_state = results[False]
    remat_calls, remat_state = results[True]
    assert set(plain_calls.values()) == {1}
    for name, count in remat_calls.items():
        segment = name.split(".")[1]
        want = 2 if segment in ("encoder", "decoder", "tower_fusion") else 1
        assert count == want, (name, count)
    for name, value in plain_state.items():
        assert torch.equal(remat_state[name], value), name


def test_recompute_outside_dropout_rng(base):
    """The forward draws under ``dropout_rng``; the backward runs in a
    context with no generator (as a CUDA backward in autograd's thread)
    and replays the segments' draws: the gradients equal the plain
    model's."""
    model, batch = base
    grads = {}
    for remat in (False, True):
        m = with_remat(model, remat)
        loss, _ = torch_step.forward_loss(
            m, batch, torch.Generator().manual_seed(2), loss_name=LOSS
        )
        contextvars.Context().run(loss.backward)
        grads[remat] = {n: p.grad for n, p in m.named_parameters()}
    for name, value in grads[False].items():
        assert torch.equal(grads[True][name], value), name


def test_checkpoints_only_training_under_autograd(base, monkeypatch):
    model, batch = base
    m = with_remat(model, True)

    def refuse(*args):
        raise AssertionError("checkpointed")

    monkeypatch.setattr(tower_unet, "checkpoint", refuse)
    with torch.no_grad():
        m.eval()(batch.x)
        with dropout_rng(torch.Generator().manual_seed(3)):
            m.train()(batch.x)
    m.train()
    with pytest.raises(AssertionError, match="checkpointed"):
        with dropout_rng(torch.Generator().manual_seed(3)):
            m(batch.x)
