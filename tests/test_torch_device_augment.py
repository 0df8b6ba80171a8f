"""The port's in-step augmentation (``augment/device.py``) and in-step
input pipeline (``train/step.py::make_train_step(device_augment,
device_augment_noise, norm_stats)``) against the JAX package on the CPU.

- Each of the 8 dihedral codes equals JAX's ``_apply_one`` bit for bit on
  x, y and bdist, alone and mixed in one batch; y or bdist None passes
  through; a non-square chip raises ``ValueError`` (JAX asserts).
- The law of the draws (the two packages draw from different generators,
  so they agree in law, not in value): over 4,096 samples the codes'
  frequencies pass a chi-square test at p > 1e-3, and the noise has mean
  within 3 sigma / sqrt(n) of 0 and std within 2% of sigma.
- The step: ``make_train_step(norm_stats=..., precision="fp32")`` on an
  int16 batch, from weights translated from JAX's, at dropout 0 with the
  augmentation off, against JAX's ``make_train_step(norm_stats=...)``:
  losses within 1e-5 and the parameters and BatchNorm statistics after one
  step within 1e-5 (``tests/test_torch_train.py``'s limit). The same step
  against the host path's step on the host-scaled, host-normalized batch:
  losses within 1e-5 relative (the two dequantize formulas differ by an
  ulp in places). With augmentation on, the step draws only from its
  generator. The model is hidden 8 with no attention at T = 6 and 12 x 12,
  so that JAX's step compiles in about 10 s.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from cultionet_tpu.augment.device import _apply_one
from cultionet_tpu.augment.device import augment_batch_on_device as jax_augment
from cultionet_tpu.data.batch import Batch as JaxBatch
from cultionet_tpu.models import CultioNet as JaxCultioNet
from cultionet_tpu.train import optim as jax_optim
from cultionet_tpu.train import step as jax_step
from cultionet_tpu_torch.augment import augment_batch_on_device
from cultionet_tpu_torch.augment.device import apply_dihedral
from cultionet_tpu_torch.data.batch import Batch
from cultionet_tpu_torch.data.constant import SCALE_FACTOR
from cultionet_tpu_torch.models import CultioNet
from cultionet_tpu_torch.train import optim as torch_optim
from cultionet_tpu_torch.train import step as torch_step
from cultionet_tpu_torch.utils.normalize import NormValues
from cultionet_tpu_torch.utils.params import from_flax, load_flax

from torch_port_helpers import seeded_variables

LOSS = "TanimotoComplementLoss"
MODEL = dict(hidden_channels=8, dilations=[1], attention_weights=None)
MEAN = np.asarray([0.45, 0.5, 0.55], dtype=np.float32)
STD = np.asarray([0.25, 0.3, 0.28], dtype=np.float32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def sample(rng, num=1, size=5):
    x = rng.random((num, 3, size, size, 2), dtype=np.float32)
    y = rng.integers(-1, 3, (num, size, size)).astype(np.int32)
    bdist = rng.random((num, size, size), dtype=np.float32)
    return x, y, bdist


@pytest.mark.parametrize("code", range(8))
def test_code_matches_jax(code):
    x, y, bdist = sample(np.random.default_rng(code))
    want = _apply_one(jnp.asarray(x[0]), jnp.asarray(y[0]), jnp.asarray(bdist[0]), code)
    got = apply_dihedral(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(bdist),
        torch.tensor([code]),
    )
    for ours, theirs in zip(got, want):
        np.testing.assert_array_equal(ours[0].numpy(), np.asarray(theirs))


def test_mixed_codes_in_one_batch():
    x, y, bdist = sample(np.random.default_rng(9), num=16, size=6)
    codes = np.arange(16) % 8
    got_x, got_y, got_b = apply_dihedral(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(bdist),
        torch.from_numpy(codes),
    )
    want_x, want_y, want_b = jax.vmap(_apply_one)(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(bdist), jnp.asarray(codes)
    )
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))


def test_none_fields_pass_through():
    x, _, bdist = sample(np.random.default_rng(1), num=4)
    generator = torch.Generator().manual_seed(0)
    batch = Batch(x=torch.from_numpy(x), bdist=torch.from_numpy(bdist))
    out = augment_batch_on_device(batch, generator, noise_sigma=0.1)
    assert out.y is None and out.bdist.shape == bdist.shape
    out = augment_batch_on_device(Batch(x=torch.from_numpy(x)), generator)
    assert out.y is None and out.bdist is None
    assert augment_batch_on_device(batch, generator, dihedral=False) is batch


def test_non_square_chips_raise():
    x = np.zeros((2, 3, 4, 5, 2), dtype=np.float32)
    with pytest.raises(ValueError, match="square"):
        augment_batch_on_device(Batch(x=torch.from_numpy(x)), torch.Generator())
    with pytest.raises(AssertionError, match="square"):
        jax_augment(JaxBatch(x=jnp.asarray(x)), jax.random.PRNGKey(0))


def test_codes_and_noise_follow_their_law():
    num = 4096
    # A 2 x 2 grid of distinct values: the 8 transforms give 8 patterns.
    grid = torch.arange(4, dtype=torch.float32).reshape(1, 1, 2, 2, 1)
    batch = Batch(x=grid.expand(num, 1, 2, 2, 1).contiguous())
    generator = torch.Generator().manual_seed(123)
    out = augment_batch_on_device(batch, generator).x.reshape(num, 4)
    patterns = apply_dihedral(grid.expand(8, 1, 2, 2, 1), None, None, torch.arange(8))[0]
    patterns = patterns.reshape(8, 4)
    codes = (out[:, None, :] == patterns[None]).all(-1).float().argmax(1)
    assert bool((out == patterns[codes]).all())
    counts = torch.bincount(codes, minlength=8).numpy()
    assert stats.chisquare(counts).pvalue > 1e-3, counts

    sigma = 0.05
    zeros = Batch(x=torch.zeros(num, 2, 4, 4, 3))
    noise = augment_batch_on_device(
        zeros, generator, dihedral=False, noise_sigma=sigma
    ).x.double()
    n = noise.numel()
    assert abs(float(noise.mean())) < 3 * sigma / np.sqrt(n)
    assert abs(float(noise.std()) / sigma - 1) < 0.02


@pytest.fixture(scope="module")
def setup():
    jax_model = JaxCultioNet(in_time=6, dropout=0.0, **MODEL)
    variables = seeded_variables(
        jax_model, JaxBatch(x=jnp.zeros((1, 6, 12, 12, 3))), training=False,
        seed=8,
    )
    model = load_flax(CultioNet(in_time=6, dropout=0.0, **MODEL), variables)
    rng = np.random.default_rng(4)
    x = (rng.random((2, 6, 12, 12, 3)) * 1.1 * SCALE_FACTOR).astype(np.int16)
    y = rng.integers(-1, 3, (2, 12, 12)).astype(np.int16)
    bdist = (rng.random((2, 12, 12)) * SCALE_FACTOR).astype(np.int16)
    return jax_model, variables, model, (x, y, bdist)


def _optimizers():
    """AdamW at a constant 1e-3, weight decay 1e-3, in both packages."""
    return tuple(
        module.build_optimizer("AdamW", 1e-3, weight_decay=1e-3, eps=1e-4)
        for module in (jax_optim, torch_optim)
    )


def test_in_step_pipeline_matches_jax(setup):
    jax_model, variables, model, (x, y, bdist) = setup
    jax_tx, torch_tx = _optimizers()
    state = jax_step.TrainState.create(
        apply_fn=jax_model.apply,
        params=variables["params"],
        batch_stats=variables["batch_stats"],
        tx=jax_tx,
    )
    jax_train = jax_step.make_train_step(
        loss_name=LOSS, donate=False, norm_stats=(MEAN, STD)
    )
    state, want = jax_train(
        state,
        JaxBatch(x=jnp.asarray(x), y=jnp.asarray(y), bdist=jnp.asarray(bdist)),
        jax.random.PRNGKey(0),
    )
    torch_state = torch_step.create_train_state(
        copy.deepcopy(model), torch_tx, device="cpu"
    )
    step = torch_step.make_train_step(
        loss_name=LOSS, norm_stats=(MEAN, STD), precision="fp32", device="cpu"
    )
    batch = Batch(
        x=torch.from_numpy(x), y=torch.from_numpy(y), bdist=torch.from_numpy(bdist)
    )
    torch_state, got = step(torch_state, batch, torch.Generator().manual_seed(0))
    for name in ("loss", "dloss", "eloss", "closs"):
        np.testing.assert_allclose(
            float(got[name]), float(want[name]), atol=1e-5, err_msg=name
        )
    want_state = from_flax(
        {"params": state.params, "batch_stats": state.batch_stats}
    )
    got_state = torch_state.model.state_dict()
    for name, value in want_state.items():
        np.testing.assert_allclose(
            got_state[name].numpy(), value.numpy(), atol=1e-5, err_msg=name
        )


def test_in_step_pipeline_matches_the_host_path(setup):
    _, _, model, (x, y, bdist) = setup
    norm = NormValues(MEAN, STD, np.ones(2), np.ones(2), num_channels=3)
    host = Batch(
        x=torch.from_numpy(np.clip(x.astype(np.float32) / SCALE_FACTOR, 1e-9, 1.0)),
        y=torch.from_numpy(y.astype(np.int32)),
        bdist=torch.from_numpy(
            np.clip(bdist.astype(np.float32) / SCALE_FACTOR, 1e-9, 1.0)
        ),
    )
    host = norm(host)
    raw = Batch(
        x=torch.from_numpy(x), y=torch.from_numpy(y), bdist=torch.from_numpy(bdist)
    )
    logs = []
    for norm_stats, batch in (((MEAN, STD), raw), (None, host)):
        state = torch_step.create_train_state(
            copy.deepcopy(model), _optimizers()[1], device="cpu"
        )
        step = torch_step.make_train_step(
            loss_name=LOSS, norm_stats=norm_stats, device="cpu"
        )
        logs.append(step(state, batch, torch.Generator().manual_seed(0))[1])
    for name in ("loss", "dloss", "eloss", "closs"):
        np.testing.assert_allclose(
            float(logs[0][name]), float(logs[1][name]), rtol=1e-5, err_msg=name
        )


def test_augmenting_step_draws_from_its_generator(setup):
    _, _, model, (x, y, bdist) = setup
    batch = Batch(
        x=torch.from_numpy(x), y=torch.from_numpy(y), bdist=torch.from_numpy(bdist)
    )
    step = torch_step.make_train_step(
        loss_name=LOSS, norm_stats=(MEAN, STD), device_augment=True,
        device_augment_noise=0.01, device="cpu",
    )
    global_rng = torch.random.get_rng_state()
    losses = []
    for seed in (0, 0, 1):
        state = torch_step.create_train_state(
            copy.deepcopy(model), _optimizers()[1], device="cpu"
        )
        generator = torch.Generator().manual_seed(seed)
        losses.append(float(step(state, batch, generator)[1]["loss"]))
        assert not torch.equal(
            generator.get_state(), torch.Generator().manual_seed(seed).get_state()
        )
    assert losses[0] == losses[1] != losses[2]
    assert torch.equal(torch.random.get_rng_state(), global_rng)
