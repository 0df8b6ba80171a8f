"""The device-resident train step as a CUDA graph on the card
(``cultionet_tpu_torch/train/graphed.py``), at the CLI-default model's
size (batch 4 of 100 x 100 x T12, hidden 64, dropout 0.2, in-step
dihedral augmentation, AdamW with the OneCycle learning rate and beta1),
with either temporal encoder: the convolutional one and the transformer
(its attention kernels, LayerNorm and dropout inside the graph).

- Six graphed steps (two eager warm-ups on the side stream, the capture,
  three replays) follow six eager steps from the same seed: in fp32 the
  losses within 1e-5 relative and the parameters within 1e-5, in
  "16-mixed" the losses within the benchmark's ``loss_gap`` limit.
- Each replay draws new dihedral codes, dropout masks and attention
  seeds: the generator moves as the eager step moves it.
- A caller's logs keep their values after the next replay; the kernel
  launch counters rise by one step's launches each replay.
- An optimizer ``state_dict`` taken after replays reloads into an eager
  run that resumes as the graphed one goes on.
- A replay under ``torch.profiler`` lists the attention kernels.

Needs a CUDA card; skipped without one. This file imports neither JAX nor
the JAX package, so it runs on a machine without them:
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_train_graph_card.py``.
"""

import copy

import numpy as np
import pytest
import torch

from cultionet_tpu_torch.data.device_cache import gather_batch
from cultionet_tpu_torch.models import CultioNet
from cultionet_tpu_torch.ops import natten_cuda, temporal_cuda
from cultionet_tpu_torch.train import optim as torch_optim
from cultionet_tpu_torch.train.step import (
    create_train_state, make_hbm_train_step, make_train_step,
)
from cultionet_tpu_torch.utils import profiling

CHIPS, BATCH, SIDE, TIME, BANDS = 16, 4, 100, 12, 3
STEPS = 6
LOSS_GAP = 0.0016  # the train-conv-hbm cell's limit (portbench/workloads)
ENCODERS = ["conv", "transformer"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run these tests on a machine with one")
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda:0")
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic) = tf32


def resident(device):
    rng = np.random.default_rng(0)
    arrays = {
        "x": rng.integers(1, 10000, size=(CHIPS, TIME, SIDE, SIDE, BANDS)),
        "y": rng.integers(-1, 3, size=(CHIPS, SIDE, SIDE)),
        "bdist": rng.integers(0, 10000, size=(CHIPS, SIDE, SIDE)),
    }
    arrays = {k: torch.from_numpy(v.astype(np.int16)).to(device) for k, v in arrays.items()}
    rows = [rng.permutation(CHIPS)[:BATCH] for _ in range(STEPS + 2)]
    return arrays, [torch.from_numpy(r).to(device) for r in rows]


def setup(device, precision, weights=None, encoder="conv"):
    torch.manual_seed(0)
    model = CultioNet(in_time=TIME, in_channels=BANDS, hidden_channels=64,
                      dilations=[1, 2], attention_weights="natten",
                      activation_type="SiLU", dropout=0.2,
                      temporal_encoder=encoder)
    spec = torch_optim.build_optimizer(
        "AdamW",
        learning_rate=torch_optim.build_schedule("OneCycleLR", 0.01, 100, 512 // BATCH),
        weight_decay=1e-3, eps=1e-4, gradient_clip_val=1.0,
        b1_schedule=torch_optim.build_momentum_schedule("OneCycleLR", 100, 512 // BATCH),
    )
    state = create_train_state(model, spec, seed=None if weights else 3, device=device)
    if weights:
        state.model.load_state_dict(weights)
    norm = (np.array([0.4, 0.5, 0.45], np.float32), np.array([0.2, 0.25, 0.3], np.float32))
    inner = make_train_step(loss_name="TanimotoComplementLoss", precision=precision,
                            device=device, device_augment=True, norm_stats=norm)
    generator = torch.Generator(device=device).manual_seed(7)
    return state, inner, generator


def eager_step(inner):
    def step(state, arrays, indices, generator):
        return inner(state, gather_batch(arrays, indices), generator)

    return step


def run(step, state, arrays, rows, generator, steps=STEPS):
    losses, gen_states = [], []
    for indices in rows[:steps]:
        state, logs = step(state, arrays, indices, generator)
        losses.append(logs["loss"])
        gen_states.append(generator.get_state())
    return [float(v) for v in losses], gen_states


def params(state):
    return {n: p.detach().clone() for n, p in state.model.named_parameters()}


@pytest.mark.card
@pytest.mark.parametrize("encoder", ENCODERS)
@pytest.mark.parametrize("precision", ["fp32", "16-mixed"])
def test_graphed_steps_follow_eager_steps(card, precision, encoder):
    arrays, rows = resident(card)
    state, inner, gen = setup(card, precision, encoder=encoder)
    weights = copy.deepcopy(state.model.state_dict())
    replays0 = profiling.COUNTS["graph_replays"]
    graphed = make_hbm_train_step(inner, device=card)
    got, got_gens = run(graphed, state, arrays, rows, gen)
    assert profiling.COUNTS["graph_replays"] - replays0 == STEPS - 2
    assert state.step == state.optimizer.count == STEPS
    got_params = params(state)

    state, inner, gen = setup(card, precision, weights, encoder)
    want, want_gens = run(eager_step(inner), state, arrays, rows, gen)
    assert state.step == state.optimizer.count == STEPS
    # The generator moves as the eager step moves it: every replay draws
    # new codes, masks and seeds.
    for a, b in zip(got_gens, want_gens):
        assert torch.equal(a, b)
    assert all(not torch.equal(a, b) for a, b in zip(got_gens, got_gens[1:]))
    if precision == "fp32":
        np.testing.assert_allclose(got, want, rtol=1e-5)
        for name, p in params(state).items():
            torch.testing.assert_close(got_params[name], p, rtol=1e-5, atol=1e-5)
    else:
        gap = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(got, want))
        assert gap <= LOSS_GAP, (got, want)


def launch_counts():
    return {**natten_cuda.LAUNCHES, **temporal_cuda.LAUNCHES}


@pytest.mark.card
@pytest.mark.parametrize("encoder", ENCODERS)
def test_logs_launches_and_resume(card, encoder):
    arrays, rows = resident(card)
    state, inner, gen = setup(card, "16-mixed", encoder=encoder)
    graphed = make_hbm_train_step(inner, device=card)
    launches = []
    logs = []
    for indices in rows[:5]:
        before = launch_counts()
        state, out = graphed(state, arrays, indices, gen)
        logs.append((out, {k: float(v) for k, v in out.items()}))
        launches.append({k: v - before[k] for k, v in launch_counts().items()})
    # Eager, capture and replayed steps count the same launches.
    assert launches[0]["na2d_fwd_drop"] > 0 and all(m == launches[0] for m in launches)
    assert (launches[0]["temporal_fwd"] > 0) == (encoder == "transformer")
    # A caller's logs of step k keep their values after step k + 1.
    for out, values in logs:
        assert {k: float(v) for k, v in out.items()} == values
    assert len({values["loss"] for _, values in logs[2:]}) == 3

    # The state after replays reloads into an eager run that resumes as
    # the graphed run goes on.
    saved_model = copy.deepcopy(state.model.state_dict())
    saved_opt = copy.deepcopy(state.optimizer.state_dict())
    saved_gen = gen.get_state()
    go_on, _ = run(graphed, state, arrays, rows[5:], gen, steps=2)
    on_params = params(state)
    state2, inner2, gen2 = setup(card, "16-mixed", saved_model, encoder)
    state2.optimizer.load_state_dict(saved_opt)
    gen2.set_state(saved_gen)
    resumed, _ = run(eager_step(inner2), state2, arrays, rows[5:], gen2, steps=2)
    np.testing.assert_allclose(resumed, go_on, rtol=1e-5)
    for name, p in params(state2).items():
        torch.testing.assert_close(on_params[name], p, rtol=1e-5, atol=1e-5)


@pytest.mark.card
def test_profiled_replay_lists_the_attention_kernels(card):
    arrays, rows = resident(card)
    state, inner, gen = setup(card, "16-mixed")
    graphed = make_hbm_train_step(inner, device=card)
    run(graphed, state, arrays, rows, gen, steps=3)  # the capture is the third
    torch.cuda.synchronize()
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        graphed(state, arrays, rows[3], gen)
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    kernels = [e.name() for e in events if "CUDA" in str(e.device_type())]
    assert any("na2d_fwd" in k for k in kernels) and any("na2d_bwd" in k for k in kernels)
    assert profiling.totals()["train.replay"]["count"] == 1
