"""The CUDA graph of the device-resident train step
(``cultionet_tpu_torch/train/graphed.py``) and what it rests on, on the
CPU (the graph itself runs only on a card:
``tests/test_torch_train_graph_card.py``).

- The step's host-to-device copies are gone and no number moved:
  ``dequantize`` by a Python factor and the resize matrices cached on the
  device give bit for bit what the 0-d tensor and the per-call matrix
  gave, at every resize of the CLI-default model at 100 and 140 px; the
  cache returns one tensor.
- The optimizer on device scalars (Adam's update with the learning rate,
  beta1 and the bias corrections read from 0-d tensors), which every Adam
  and AdamW runs, follows torch's own ``AdamW`` over 10 OneCycle steps
  with the global-norm clip, and torch's ``Adam`` with beta1 kept at 0.9.
- The engagement rule keeps every setup it cannot see to be safe eager:
  the CPU, a gradient all-reduce, accumulation, RAdam, SGD,
  rematerialized segments, the plain attention path; another index shape
  (or model, optimizer load, generator) starts a new warm-up.
"""

import numpy as np
import pytest
import torch

from cultionet_tpu_torch.data import batch as batch_module
from cultionet_tpu_torch.data.constant import SCALE_FACTOR
from cultionet_tpu_torch.models import CultioNet
from cultionet_tpu_torch.nn import blocks, resize
from cultionet_tpu_torch.ops import flags
from cultionet_tpu_torch.train import graphed
from cultionet_tpu_torch.train import optim as torch_optim
from cultionet_tpu_torch.train.step import TrainState, create_train_state, make_train_step


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CLI_MODEL = dict(in_channels=3, hidden_channels=8, dilations=[1, 2],
                 attention_weights="natten", activation_type="SiLU",
                 temporal_encoder="conv", dropout=0.2)


def old_dequantize(x, dtype=torch.float32):
    return x.to(dtype) * torch.tensor(1.0 / SCALE_FACTOR, dtype=dtype, device=x.device)


def old_resize(x, size):
    out_h, out_w = int(size[0]), int(size[1])
    in_h, in_w = x.shape[-2:]
    if (in_h, in_w) == (out_h, out_w):
        return x

    def matrix(o, i):
        return torch.from_numpy(resize._interp_matrix(o, i)).to(dtype=x.dtype)

    if in_h != out_h:
        x = torch.einsum("hi,bciw->bchw", matrix(out_h, in_h), x)
    if in_w != out_w:
        x = torch.einsum("wj,bchj->bchw", matrix(out_w, in_w), x)
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dequantize_equals_the_tensor_factor(dtype):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(-32768, 32767, size=(3, 5, 17, 17, 3), dtype=np.int16))
    want = old_dequantize(x, dtype)
    got = batch_module.dequantize(x, dtype)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.fixture(scope="module")
def resize_sizes():
    """Each (input size, output size) of the CLI-default model's resizes in
    a forward at 100 and 140 px (the layout does not depend on the
    width)."""
    seen = set()
    real = resize.resize_bilinear_align_corners

    def recording(x, size):
        seen.add((tuple(x.shape[-2:]), (int(size[0]), int(size[1]))))
        return real(x, size)

    model = CultioNet(in_time=5, **CLI_MODEL).eval()
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(blocks, "resize_bilinear_align_corners", recording)
        with torch.no_grad():
            for side in (100, 140):
                model(torch.rand(1, 5, side, side, 3))
    return sorted(seen)


def test_the_model_resizes_at_both_sizes(resize_sizes):
    inputs = {s[0] for s in resize_sizes}
    assert any(h < 100 for h, _ in inputs) and any(h > 100 for h, _ in inputs)
    assert any(i != o for i, o in resize_sizes)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cached_resize_is_bit_identical(resize_sizes, dtype):
    gen = torch.Generator().manual_seed(1)
    for (in_h, in_w), size in resize_sizes:
        x = torch.randn(2, 3, in_h, in_w, generator=gen).to(dtype)
        got = resize.resize_bilinear_align_corners(x, size)
        want = old_resize(x, size)
        assert torch.equal(got, want), ((in_h, in_w), size)


def test_resize_cache_returns_one_tensor():
    x = torch.zeros(1, 1, 5, 5)
    first = resize._matrix(9, 5, x)
    assert resize._matrix(9, 5, x) is first
    assert resize._matrix(9, 5, x.double()) is not first
    # Made in inference mode, the cached matrix still serves a training
    # forward that saves it for the backward.
    resize._matrix_on.cache_clear()
    with torch.inference_mode():
        resize._matrix(11, 5, x)
    y = torch.ones(1, 1, 5, 5, requires_grad=True)
    resize.resize_bilinear_align_corners(y, (11, 11)).sum().backward()
    assert y.grad is not None


def onecycle_spec(total_steps=40, optimizer="AdamW"):
    return torch_optim.build_optimizer(
        optimizer,
        learning_rate=torch_optim.build_schedule("OneCycleLR", 0.01, 1, total_steps),
        weight_decay=1e-3,
        eps=1e-4,
        gradient_clip_val=1.0,
        b1_schedule=torch_optim.build_momentum_schedule("OneCycleLR", 1, total_steps),
    )


def oracle_and_scalar_optimizers(optimizer="AdamW"):
    """The same start under the port's update (every Adam and AdamW) and
    under torch's own ``AdamW`` or ``Adam`` built directly, the oracle."""
    gen = torch.Generator().manual_seed(3)
    shapes = [(7, 5), (5,), (3, 3, 2)]
    start = [torch.randn(s, generator=gen) for s in shapes]
    scalar_params = [p.clone().requires_grad_() for p in start]
    scalar_opt = onecycle_spec(optimizer=optimizer).init(scalar_params)
    oracle_params = [p.clone().requires_grad_() for p in start]
    if optimizer == "AdamW":
        oracle = torch.optim.AdamW(oracle_params, betas=(0.9, 0.98), eps=1e-4,
                                   weight_decay=1e-3)
    else:
        oracle = torch.optim.Adam(oracle_params, betas=(0.9, 0.999), eps=1e-4)
    assert scalar_opt.device_scalars
    return gen, shapes, start, (oracle_params, oracle), (scalar_params, scalar_opt)


def oracle_step(oracle, params, grads, spec, count):
    """One update of the oracle at update count ``count``: the gradients
    clipped to global norm 1 as optax clips them, the learning rate and
    AdamW's beta1 set from the spec's schedules (plain Adam keeps 0.9)."""
    norm = torch.nn.utils.get_total_norm(grads)
    scale = torch.where(norm < 1.0, torch.ones_like(norm), 1.0 / norm)
    group = oracle.param_groups[0]
    group["lr"] = spec.learning_rate(count)
    if isinstance(oracle, torch.optim.AdamW):
        group["betas"] = (spec.b1_schedule(count), group["betas"][1])
    for p, g in zip(params, grads):
        p.grad = g * scale
    oracle.step()


def test_device_scalars_follow_the_float_path():
    gen, shapes, start, (oracle_params, oracle), (scalar_params, scalar_opt) = (
        oracle_and_scalar_optimizers()
    )
    for count in range(10):
        grads = [torch.randn(s, generator=gen) for s in shapes]
        oracle_step(oracle, oracle_params, grads, scalar_opt.spec, count)
        for p, g in zip(scalar_params, grads):
            p.grad = g.clone()
        assert scalar_opt.step()
    assert scalar_opt.count == 10
    for a, b, p0 in zip(oracle_params, scalar_params, start):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7)
        assert not torch.equal(a, p0)
    oracle_state = oracle.state
    scalar_state = scalar_opt.torch_optimizer.state
    for a, b in zip(oracle_params, scalar_params):
        assert float(scalar_state[b]["step"]) == float(oracle_state[a]["step"]) == 10
        for name in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(scalar_state[b][name], oracle_state[a][name],
                                       rtol=1e-6, atol=1e-8)
    # The scalars the last update read: the schedules at count 9, t = 10.
    spec = scalar_opt.spec
    b1 = spec.b1_schedule(9)
    assert float(scalar_opt.scalars["beta1"]) == pytest.approx(b1, rel=1e-7)
    assert float(scalar_opt.scalars["neg_step_size"]) == pytest.approx(
        -spec.learning_rate(9) / (1 - spec.b1_schedule(9) ** 10), rel=1e-6)


def test_plain_adam_keeps_beta1_at_its_default():
    # build_optimizer: Adam's beta1 is 0.9 whatever b1_schedule says.
    gen, shapes, start, (oracle_params, oracle), (scalar_params, scalar_opt) = (
        oracle_and_scalar_optimizers(optimizer="Adam")
    )
    assert scalar_opt.spec.b1_schedule(5) != 0.9
    for count in range(5):
        grads = [torch.randn(s, generator=gen) for s in shapes]
        oracle_step(oracle, oracle_params, grads, scalar_opt.spec, count)
        for p, g in zip(scalar_params, grads):
            p.grad = g.clone()
        assert scalar_opt.step()
        assert float(scalar_opt.scalars["beta1"]) == pytest.approx(0.9, rel=1e-7)
    for a, b, p0 in zip(oracle_params, scalar_params, start):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7)
        assert not torch.equal(a, p0)


def tiny_state(optimizer="AdamW", remat=False, **spec):
    torch.manual_seed(0)
    model = CultioNet(in_time=5, in_channels=3, hidden_channels=4, dilations=[1, 2],
                      remat=remat)
    return create_train_state(
        model, torch_optim.build_optimizer(optimizer, **spec), device="cpu"
    )


def reason(state=None, inner=None, indices=None, generator=None):
    state = tiny_state() if state is None else state
    inner = make_train_step(device="cpu") if inner is None else inner
    indices = torch.arange(2) if indices is None else indices
    generator = torch.Generator() if generator is None else generator
    return graphed.eager_reason(state, inner, indices, generator)


def test_engagement_rule_keeps_each_excluded_setup_eager():
    assert reason() == "not on CUDA"
    all_reduce = make_train_step(device="cpu", reduce_gradients=lambda model: None)
    assert "all-reduces" in reason(inner=all_reduce)
    assert "all-reduces" in reason(inner=lambda state, batch, generator: None)
    assert reason(state=tiny_state(accumulate_grad_batches=2)) == "gradient accumulation"
    host_scalars = "the optimizer's update reads its scalars on the host"
    for name in ("RAdam", "SGD"):
        assert reason(state=tiny_state(name)) == host_scalars
    assert reason(state=tiny_state(remat=True)) == "rematerialized segments"
    stand_in = TrainState(tiny_state().model, optimizer=object())
    assert reason(state=stand_in) == host_scalars
    flags.set_cuda_natten(False)
    try:
        assert reason() == "the plain attention path"
    finally:
        flags.set_cuda_natten(True)


def test_plan_warms_up_captures_replays_and_starts_over():
    step = graphed.GraphedStep(eager=None, inner=None)
    asked = []

    def safe():
        asked.append(1)
        return None

    four, three = ("setup", (4,)), ("setup", (3,))
    assert [step.plan(four, safe) for _ in range(3)] == ["eager", "eager", "capture"]
    step.graph = object()  # what a capture leaves
    assert [step.plan(four, safe) for _ in range(2)] == ["replay", "replay"]
    assert len(asked) == 1
    # Another index shape: the graph goes, and the warm-up starts over.
    assert step.plan(three, safe) == "eager" and step.graph is None
    assert [step.plan(three, safe) for _ in range(2)] == ["eager", "capture"]
    assert step.plan(four, lambda: "not on CUDA") == "eager"
    assert [step.plan(four, safe) for _ in range(3)] == ["eager"] * 3


def test_key_changes_with_each_part_of_the_setup():
    step = graphed.GraphedStep(eager=None, inner=None)
    state = tiny_state()
    arrays = {"x": torch.zeros(4, 2), "y": None}
    generator = torch.Generator()
    key = step._key(state, arrays, torch.arange(2), generator)
    assert step._key(state, arrays, torch.arange(2), generator) == key
    others = [
        step._key(state, arrays, torch.arange(3), generator),
        step._key(state, arrays, torch.arange(2, dtype=torch.int32), generator),
        step._key(state, {"x": torch.zeros(4, 2)}, torch.arange(2), generator),
        step._key(state, arrays, torch.arange(2), torch.Generator()),
        step._key(tiny_state(), arrays, torch.arange(2), generator),
    ]
    assert all(k != key for k in others)
    state.optimizer.load_state_dict(state.optimizer.state_dict())
    assert step._key(state, arrays, torch.arange(2), generator) != key
