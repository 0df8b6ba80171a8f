"""The U-TAE train step over a resident split as a CUDA graph on the card
(``train/graphed.py``), at the published widths (batch 4 of 128 x 128 x
10 bands, dates padded to 16 with 5 to 16 real a chip; Adam at a constant
1e-3, cross-entropy with the void class at weight 0, dropout in L-TAE).

- Each of six graphed steps (two eager warm-ups on the side stream, the
  capture, three replays) equals an eager step from the same state and
  generator: the loss to round-off, the gradient (Adam's first moment) to
  the scatter of the backward's atomic sums. The batches' date counts
  differ step to step, so the replays read the pad mask from the gathered
  rows, not from the capture.
- Each replay draws new dropout masks: the generator moves as the eager
  step moves it.

Needs a CUDA card; skipped without one. No JAX:
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_utae_card.py``.
"""

import copy

import numpy as np
import pytest
import torch

from cultionet_tpu_torch.data.device_cache import gather_batch
from cultionet_tpu_torch.models import UTAE
from cultionet_tpu_torch.train import optim as torch_optim
from cultionet_tpu_torch.train.step import (
    create_train_state, make_hbm_train_step, make_train_step,
)
from cultionet_tpu_torch.utils import profiling

CHIPS, BATCH, SIDE, TIME, BANDS = 12, 4, 128, 16, 10
STEPS = 6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run these tests on a machine with one")
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda:0")
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic) = saved


def resident(device):
    rng = np.random.default_rng(0)
    counts = rng.integers(5, TIME + 1, size=CHIPS)
    x = rng.integers(1, 10000, size=(CHIPS, TIME, SIDE, SIDE, BANDS))
    x[np.arange(TIME)[None] >= counts[:, None]] = 0
    dates = np.sort(rng.integers(0, 430, size=(CHIPS, TIME)), axis=1)
    arrays = {
        "x": x, "y": rng.integers(0, 20, size=(CHIPS, SIDE, SIDE)), "dates": dates,
        "date_count": counts,
    }
    arrays = {k: torch.from_numpy(v.astype(np.int16)).to(device) for k, v in arrays.items()}
    rows = [rng.permutation(CHIPS)[:BATCH] for _ in range(STEPS)]
    return arrays, [torch.from_numpy(r).to(device) for r in rows]


def setup(device, precision, weights=None):
    torch.manual_seed(0)
    model = UTAE(in_channels=BANDS)
    spec = torch_optim.build_optimizer(
        "Adam", learning_rate=torch_optim.build_schedule("Constant", 1e-3, 100, 128),
        weight_decay=0.0, eps=1e-8, gradient_clip_val=None,
    )
    state = create_train_state(model, spec, seed=None if weights else 3, device=device)
    if weights:
        state.model.load_state_dict(weights)
    norm = (np.full(BANDS, 0.5, np.float32), np.full(BANDS, 0.29, np.float32))
    inner = make_train_step(loss_name="CrossEntropyLoss", precision=precision, device=device,
                            norm_stats=norm)
    return state, inner, torch.Generator(device=device).manual_seed(7)


def eager_step(inner):
    def step(state, arrays, indices, generator):
        return inner(state, gather_batch(arrays, indices), generator)

    return step


def snapshot(state, generator):
    return (copy.deepcopy(state.model.state_dict()),
            copy.deepcopy(state.optimizer.state_dict()), generator.get_state())


def eager_from(snap, card, precision, arrays, indices):
    """One eager step from a snapshot: its loss and Adam's first moments
    (which hold the step's gradient linearly, unlike the update Adam
    normalizes)."""
    weights, opt_state, gen_state = snap
    state, inner, gen = setup(card, precision, weights)
    state.optimizer.load_state_dict(opt_state)
    gen.set_state(gen_state)
    state, logs = eager_step(inner)(state, arrays, indices, gen)
    return float(logs["loss"]), moments(state), gen.get_state()


def moments(state):
    slots = state.optimizer.torch_optimizer.state
    return torch.cat([slots[p]["exp_avg"].flatten() for p in state.model.parameters()])


@pytest.mark.card
@pytest.mark.parametrize("precision", ["fp32", "16-mixed"])
def test_graphed_utae_steps_follow_eager_steps(card, precision):
    """Each of six graphed steps (two eager warm-ups on the side stream,
    the capture, three replays) against eager steps from the same state
    and generator: the forward has only deterministic kernels, so the
    losses agree to round-off (1e-5 relative in fp32, 1e-3 in bf16); the
    backward has atomic sums (the upsampling's and the reflection pad's),
    which differ from run to run, so the step's gradient (Adam's first
    moment) is held to within 4 times the gap between two eager runs of the
    same step, or 1e-5 of its norm. Comparing a whole run instead would
    compound that scatter: a random network this deep amplifies it some
    1e4 times within a few updates."""
    arrays, rows = resident(card)
    assert len({int(arrays["date_count"][r].sum()) for r in rows}) > 1
    state, inner, gen = setup(card, precision)
    graphed = make_hbm_train_step(inner, device=card)
    replays0 = profiling.COUNTS["graph_replays"]
    loss_rtol = 1e-5 if precision == "fp32" else 1e-3
    gen_states = []
    for k, indices in enumerate(rows):
        snap = snapshot(state, gen)
        state, logs = graphed(state, arrays, indices, gen)
        got_loss, got_moments = float(logs["loss"]), moments(state)
        gen_states.append(gen.get_state())
        want_loss, want_moments, want_gen = eager_from(snap, card, precision, arrays, indices)
        _, again_moments, _ = eager_from(snap, card, precision, arrays, indices)
        assert torch.equal(gen.get_state(), want_gen), k
        assert abs(got_loss - want_loss) <= loss_rtol * abs(want_loss), (k, got_loss, want_loss)
        scatter = (again_moments - want_moments).norm()
        gap = (got_moments - want_moments).norm()
        assert gap <= 4 * scatter + 1e-5 * want_moments.norm(), (k, gap.item(), scatter.item())
    assert profiling.COUNTS["graph_replays"] - replays0 == STEPS - 2
    assert state.step == state.optimizer.count == STEPS
    assert all(not torch.equal(a, b) for a, b in zip(gen_states, gen_states[1:]))
