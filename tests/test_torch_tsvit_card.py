"""TSViT on the card: its temporal attention site through the hand-written
kernels, and its train step over a resident split as a CUDA graph.

- The temporal op at TSViT's site (the 19 class tokens and 60 dates, S =
  79, C = 4 x 32, q, k and v the thirds of one projection) in bf16,
  forward and backward, against the plain version in fp32 on the same
  bf16 inputs: the card's limits of the other temporal sites, 2e-2
  forward and 5e-2 for the gradients, and one launch of each kernel.
- The TSViT step (published widths, "16-mixed", Adam, masked
  cross-entropy) through ``make_hbm_train_step``: the third call captures
  and every later call replays one graph, 8 temporal launches a step (a
  forward and a backward a temporal layer) and 19 of each LayerNorm
  training kernel (its 19 LayerNorms); a replay's loss equals an eager
  step's from the same state and generator within bf16's round-off.

Needs a CUDA card; skipped without one. No JAX:
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_tsvit_card.py``.
"""

import copy

import numpy as np
import pytest
import torch

from cultionet_tpu_torch.data.device_cache import gather_batch
from cultionet_tpu_torch.models import TSViT
from cultionet_tpu_torch.ops import layer_norm_cuda, temporal_cuda
from cultionet_tpu_torch.ops.temporal import temporal_attention_reference
from cultionet_tpu_torch.train import optim as torch_optim
from cultionet_tpu_torch.train.step import (
    create_train_state, make_hbm_train_step, make_train_step,
)
from cultionet_tpu_torch.utils import profiling

TILES, BATCH, SIDE, TIME, BANDS = 48, 16, 24, 60, 10
STEPS = 6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run these tests on a machine with one")
    return torch.device("cuda:0")


@pytest.mark.card
def test_temporal_site_at_79_steps_in_bf16(card):
    n, s, c, heads = 16 * 144, 19 + TIME, 128, 4
    g = torch.Generator(device=card).manual_seed(0)
    qkv = torch.randn(n, s, 3 * c, generator=g, device=card).to(torch.bfloat16)
    grad = torch.randn(n, s, c, generator=g, device=card).to(torch.bfloat16)
    q, k, v = (t.requires_grad_() for t in qkv.detach().chunk(3, dim=-1))
    before = dict(temporal_cuda.LAUNCHES)
    out = temporal_cuda.temporal_attention_cuda(q, k, v, heads)
    got = torch.autograd.grad(out, (q, k, v), grad)
    assert temporal_cuda.LAUNCHES["temporal_fwd"] == before["temporal_fwd"] + 1
    assert temporal_cuda.LAUNCHES["temporal_bwd"] == before["temporal_bwd"] + 1
    plain = [t.detach().float().requires_grad_() for t in (q, k, v)]
    want = temporal_attention_reference(*plain, heads)
    wanted = torch.autograd.grad(want, plain, grad.float())
    assert (out.float() - want).abs().max() <= 2e-2
    for name, a, b in zip("qkv", got, wanted):
        assert (a.float() - b).abs().max() <= 5e-2, name


def resident(device):
    rng = np.random.default_rng(0)
    counts = rng.integers(38, TIME + 1, size=TILES)
    x = rng.integers(1, 10000, size=(TILES, TIME, SIDE, SIDE, BANDS))
    x[np.arange(TIME)[None] >= counts[:, None]] = 0
    dates = np.sort(rng.integers(0, 430, size=(TILES, TIME)), axis=1)
    arrays = {
        "x": x, "y": rng.integers(0, 20, size=(TILES, SIDE, SIDE)), "dates": dates,
        "date_count": counts,
    }
    arrays = {k: torch.from_numpy(v.astype(np.int16)).to(device) for k, v in arrays.items()}
    rows = [rng.permutation(TILES)[:BATCH] for _ in range(STEPS)]
    return arrays, [torch.from_numpy(r).to(device) for r in rows]


def setup(device, weights=None):
    torch.manual_seed(0)
    model = TSViT(in_channels=BANDS)
    spec = torch_optim.build_optimizer(
        "Adam", learning_rate=torch_optim.build_schedule("CosineAnnealingLR", 1e-3, 100, 800),
        weight_decay=0.0, eps=1e-8, gradient_clip_val=None,
    )
    state = create_train_state(model, spec, seed=None if weights else 3, device=device)
    if weights:
        state.model.load_state_dict(weights)
    norm = (np.full(BANDS, 0.5, np.float32), np.full(BANDS, 0.29, np.float32))
    inner = make_train_step(loss_name="MaskedCrossEntropyLoss", precision="16-mixed", device=device,
                            norm_stats=norm)
    return state, inner, torch.Generator(device=device).manual_seed(7)


@pytest.mark.card
def test_graphed_tsvit_step_replays(card):
    arrays, rows = resident(card)
    state, inner, gen = setup(card)
    graphed = make_hbm_train_step(inner, device=card)
    for k, indices in enumerate(rows):
        snap = (copy.deepcopy(state.model.state_dict()),
                copy.deepcopy(state.optimizer.state_dict()), gen.get_state())
        replays = profiling.COUNTS["graph_replays"]
        launches = {**temporal_cuda.LAUNCHES, **layer_norm_cuda.LAUNCHES}
        state, logs = graphed(state, arrays, indices, gen)
        got = float(logs["loss"])
        now = {**temporal_cuda.LAUNCHES, **layer_norm_cuda.LAUNCHES}
        moved = {name: now[name] - launches[name] for name in launches}
        assert moved == {"temporal_fwd": 4, "temporal_bwd": 4, "layer_norm_rows": 0,
                         "layer_norm_rows_train": 19, "layer_norm_rows_bwd": 19}, (k, moved)
        # Two eager warm-ups, then the capture (which replays once) and replays.
        assert profiling.COUNTS["graph_replays"] - replays == (k >= 2), k
        weights, opt_state, gen_state = snap
        other, eager, other_gen = setup(card, weights)
        other.optimizer.load_state_dict(opt_state)
        other_gen.set_state(gen_state)
        _, want = eager(other, gather_batch(arrays, indices), other_gen)
        want = float(want["loss"])
        assert np.isfinite(got) and abs(got - want) <= 1e-3 * abs(want), (k, got, want)
