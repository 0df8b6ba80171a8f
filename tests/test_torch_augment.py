"""The port's host augmentation (``cultionet_tpu_torch/augment/``,
``ChipDataset(augment_prob=...)``) against the JAX package on the CPU.

- Each random functional op, given the draws JAX makes from a
  ``jax.random`` key (speeds, walk steps, noise, crop origin, Perlin
  lattices), equals the JAX op to 1e-6 (float32 arithmetic in another
  order: ``F.interpolate`` against ``jax.image.resize``'s weight matrices,
  torch's ``exp``/``sin``/``cos`` against XLA's).
- The deterministic augmenters (rot90/180/270, fliplr/flipud, roll,
  gaussian, none) equal JAX on x, y and bdist exactly.
- After every one of the 15 augmenters the numpy generator is in JAX's
  state, and every draw went where JAX's went: each key seed and each
  op's drawn parameters, in JAX's order. The temporal ones change x only
  inside the crop parcels, and all keep the clip ranges.
- ``ChipDataset(augment_prob=0.5)`` picks the augmenter JAX picks for each
  sample, and its outputs equal JAX's wherever that augmenter is
  deterministic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cultionet_tpu.augment import Augmenters as JaxAugmenters
from cultionet_tpu.augment import functional as JF
from cultionet_tpu.augment import label_segments as jax_label_segments
from cultionet_tpu.data import ChipDataset as JaxDataset
from cultionet_tpu.data import create_batch as jax_create_batch
from cultionet_tpu_torch.augment import (
    AUGMENTATION_NAMES,
    TEMPORAL_NAMES,
    Augmenters,
    label_segments,
)
from cultionet_tpu_torch.augment import functional as AF
from cultionet_tpu_torch.data import datasets as port_datasets
from cultionet_tpu_torch.data.batch import Batch
from cultionet_tpu_torch.data.datasets import ChipDataset

DETERMINISTIC = (
    "rot90", "rot180", "rot270", "fliplr", "flipud", "roll", "gaussian",
    "none",
)


def _x(shape=(1, 12, 20, 20, 3), seed=0) -> np.ndarray:
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _close(got: torch.Tensor, want, atol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)


def _port_batch(jax_batch) -> Batch:
    return Batch(
        x=torch.from_numpy(np.array(jax_batch.x)),
        y=torch.from_numpy(np.array(jax_batch.y)),
        bdist=torch.from_numpy(np.array(jax_batch.bdist)),
    )


def _jax_speeds(key, n_speed_change=3, max_speed_ratio=1.5):
    """``JF.time_warp``'s speeds from ``key``."""
    log_ratio = jnp.log(max_speed_ratio)
    return jnp.exp(
        jax.random.uniform(
            key, (n_speed_change + 1,), minval=-log_ratio, maxval=log_ratio
        )
    )


@pytest.mark.parametrize("n_speed_change", [1, 2, 3])
@pytest.mark.parametrize("num_time", [12, 13])
def test_time_warp_matches_jax(n_speed_change, num_time):
    x = _x((1, num_time, 6, 5, 3))
    key = jax.random.PRNGKey(n_speed_change + num_time)
    want = JF.time_warp(jnp.asarray(x), key, n_speed_change, 1.3)
    speeds = torch.from_numpy(np.array(_jax_speeds(key, n_speed_change, 1.3)))
    _close(AF.time_warp(torch.from_numpy(x), speeds), want)


@pytest.mark.parametrize("n_drift_points", [1, 3, 5])
def test_time_drift_matches_jax(n_drift_points):
    x = _x((1, 12, 6, 5, 3))
    key = jax.random.PRNGKey(n_drift_points)
    want = JF.time_drift(jnp.asarray(x), key, 0.07, n_drift_points)
    steps = torch.from_numpy(
        np.array(jax.random.normal(key, (n_drift_points + 1,)))
    )
    _close(AF.time_drift(torch.from_numpy(x), steps, max_drift=0.07), want)


@pytest.mark.parametrize("num_time", [12, 13])
def test_time_peaks_matches_jax(num_time):
    x = _x((1, num_time, 6, 5, 3))
    key = jax.random.PRNGKey(num_time)
    want = JF.time_peaks(jnp.asarray(x), key)
    speeds = torch.from_numpy(np.array(_jax_speeds(key)))
    _close(AF.time_peaks(torch.from_numpy(x), speeds), want)


@pytest.mark.parametrize("op", ["add_time_noise", "gaussian_noise"])
def test_noise_ops_match_jax(op):
    x = _x((2, 12, 6, 5, 3))
    key = jax.random.PRNGKey(3)
    noise = torch.from_numpy(
        np.array(jax.random.normal(key, x.shape, dtype=jnp.float32))
    )
    if op == "add_time_noise":
        want = JF.add_time_noise(jnp.asarray(x), key, scale=0.04)
        got = AF.add_time_noise(torch.from_numpy(x), noise, scale=0.04)
    else:
        want = JF.gaussian_noise(jnp.asarray(x), key, sigma=0.01)
        got = AF.gaussian_noise(torch.from_numpy(x), noise, sigma=0.01)
    _close(got, want)


@pytest.mark.parametrize("size", [15, 16, 20])
@pytest.mark.parametrize("div", [2, 4])
def test_crop_resize_matches_jax(size, div):
    rng = np.random.default_rng(size * div)
    x = rng.random((2, 4, size, size + 1, 3), dtype=np.float32)
    y = rng.integers(-1, 3, (2, size, size + 1)).astype(np.int32)
    bdist = rng.random((2, size, size + 1), dtype=np.float32)
    key = jax.random.PRNGKey(size + div)
    want = JF.crop_resize(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(bdist), key, div=div
    )
    key_r, key_c = jax.random.split(key)
    row0 = int(jax.random.randint(key_r, (), 0, size - size // div + 1))
    col0 = int(jax.random.randint(key_c, (), 0, size + 1 - (size + 1) // div + 1))
    got = AF.crop_resize(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(bdist),
        row0, col0, div=div,
    )
    _close(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].dtype == torch.int32
    _close(got[2], want[2])


@pytest.mark.parametrize("res", [2, 5, 10])
def test_perlin_noise_matches_jax(res):
    shape, lattice_res = (12, 20, 20), (1, res, res)
    key = jax.random.PRNGKey(res)
    want = JF.perlin_noise_3d(key, shape, lattice_res)
    key_theta, key_phi = jax.random.split(key)
    lattice = (2, res + 1, res + 1)
    theta = 2 * jnp.pi * jax.random.uniform(key_theta, lattice)
    phi = 2 * jnp.pi * jax.random.uniform(key_phi, lattice)
    got = AF.perlin_noise_3d(
        torch.from_numpy(np.array(theta)), torch.from_numpy(np.array(phi)),
        shape, lattice_res,
    )
    _close(got, want)
    with pytest.raises(ValueError, match="multiple"):
        AF.perlin_noise_3d(
            torch.zeros(lattice), torch.zeros(lattice), (12, 21, 20),
            lattice_res,
        )


def test_gaussian_blur_and_roll_match_jax():
    x = _x((2, 12, 7, 9, 3))
    sigma = np.float32(0.37)
    _close(
        AF.gaussian_blur(torch.from_numpy(x), torch.tensor(sigma)),
        JF.gaussian_blur(jnp.asarray(x), jnp.asarray(sigma)),
    )
    np.testing.assert_array_equal(
        AF.roll_time(torch.from_numpy(x), -2).numpy(),
        np.asarray(JF.roll_time(jnp.asarray(x), -2)),
    )


def test_draws_have_the_laws_of_the_jax_draws():
    """The port's draws against the ranges of the JAX draws they stand in
    for: speeds within the ratio, crop origins inside the chip, angles in
    [0, 2 pi), standard normal noise."""
    g = torch.Generator().manual_seed(0)
    speeds = torch.stack([AF.draw_time_warp_speeds(g, 2, 1.4) for _ in range(500)])
    assert speeds.shape == (500, 3)
    assert float(speeds.min()) >= 1 / 1.4 and float(speeds.max()) <= 1.4
    origins = [AF.draw_crop_origin(g, 20, 15, 4) for _ in range(500)]
    assert {r for r, _ in origins} == set(range(20 - 5 + 1))
    assert {c for _, c in origins} == set(range(15 - 3 + 1))
    theta, phi = AF.draw_perlin_lattices(g, (1, 5, 5))
    assert theta.shape == phi.shape == (2, 6, 6)
    assert float(theta.min()) >= 0 and float(phi.max()) < 2 * np.pi
    noise = AF.draw_noise(torch.zeros(64, 64, 8), g)
    assert abs(float(noise.mean())) < 0.02 and abs(float(noise.std()) - 1) < 0.02
    assert AF.draw_drift_steps(g, 4).shape == (5,)


def test_label_segments_match_jax():
    y = np.random.default_rng(4).integers(-1, 3, (30, 30))
    np.testing.assert_array_equal(
        label_segments(y), jax_label_segments(y)
    )
    np.testing.assert_array_equal(
        label_segments(y, crop_value=2), jax_label_segments(y, crop_value=2)
    )


def _jax_and_port(name, seed):
    """One augmenter applied by both packages to one seeded 20 x 20 chip,
    each from its own numpy generator seeded alike."""
    batch = jax_create_batch(
        num_channels=3, num_time=12, height=20, width=20, batch_size=2,
        rng=np.random.default_rng(seed),
    )
    jax_rng, rng = np.random.default_rng(seed), np.random.default_rng(seed)
    want = JaxAugmenters([name], rng=jax_rng)(batch)
    got = Augmenters([name], rng=rng)(_port_batch(batch))
    return batch, want, got, jax_rng, rng


@pytest.mark.parametrize("name", DETERMINISTIC)
def test_deterministic_augmenters_equal_jax(name):
    _, want, got, _, _ = _jax_and_port(name, seed=5)
    for field in ("x", "y", "bdist"):
        np.testing.assert_array_equal(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)),
            err_msg=field,
        )


def _record_draws(monkeypatch, module, log, calls):
    """Wrap ``module``'s functions named in ``calls`` (name -> the record
    of one call's arguments) so that each call appends its record to
    ``log``."""
    for fname, record in calls.items():
        original = getattr(module, fname)

        def wrapped(*args, _original=original, _record=record, **kwargs):
            log.append(_record(*args, **kwargs))
            return _original(*args, **kwargs)

        monkeypatch.setattr(module, fname, wrapped)


@pytest.mark.parametrize("name", AUGMENTATION_NAMES)
def test_generator_state_after_each_augmenter_matches_jax(name, monkeypatch):
    """The numpy generator ends where JAX's does, and every draw went to
    the same place: each key seed, and each op's drawn parameters, in
    JAX's order."""
    import cultionet_tpu.augment.augmenters as jax_augmenters

    jax_log, log = [], []
    _record_draws(monkeypatch, JF, jax_log, {
        "time_warp": lambda x, key, n_speed_change=3, max_speed_ratio=1.5: (
            "warp", n_speed_change, max_speed_ratio
        ),
        "time_drift": lambda x, key, max_drift=0.1, n_drift_points=3: (
            "drift", max_drift, n_drift_points
        ),
        "add_time_noise": lambda x, key, scale=0.03: ("noise", scale),
        "gaussian_noise": lambda x, key, sigma=0.01: ("saltpepper", sigma),
        "crop_resize": lambda x, y, bdist, key, div: ("crop", div),
        "perlin_noise_3d": lambda key, shape, res, out_range: ("perlin", res),
        "roll_time": lambda x, shift: ("roll", int(shift)),
        "gaussian_blur": lambda x, sigma: ("blur", float(sigma)),
    })
    _record_draws(monkeypatch, AF, log, {
        "draw_time_warp_speeds": (
            lambda g, n_speed_change=3, max_speed_ratio=1.5: (
                "warp", n_speed_change, max_speed_ratio
            )
        ),
        "time_drift": lambda x, steps, max_drift=0.1: (
            "drift", max_drift, steps.shape[0] - 1
        ),
        "add_time_noise": lambda x, noise, scale=0.03: ("noise", scale),
        "gaussian_noise": lambda x, noise, sigma=0.01: ("saltpepper", sigma),
        "draw_crop_origin": lambda g, height, width, div: ("crop", div),
        "draw_perlin_lattices": lambda g, res: ("perlin", res),
        "roll_time": lambda x, shift: ("roll", int(shift)),
        "gaussian_blur": lambda x, sigma: ("blur", float(sigma)),
    })
    jax_key, port_generator = jax_augmenters.jax.random.PRNGKey, torch.Generator
    monkeypatch.setattr(
        jax_augmenters.jax.random, "PRNGKey",
        lambda seed: jax_log.append(("key", seed)) or jax_key(seed),
    )

    class RecordingGenerator(port_generator):
        def manual_seed(self, seed):
            log.append(("key", seed))
            return super().manual_seed(seed)

    monkeypatch.setattr(torch, "Generator", RecordingGenerator)
    batch, want, got, jax_rng, rng = _jax_and_port(name, seed=6)
    monkeypatch.undo()
    assert log == jax_log
    assert (name in ("none", "rot90", "rot180", "rot270", "fliplr", "flipud")) == (
        not log
    )
    assert rng.bit_generator.state == jax_rng.bit_generator.state
    assert rng.integers(0, 2**31 - 1) == jax_rng.integers(0, 2**31 - 1)
    assert got.x.shape == tuple(batch.x.shape) and got.x.dtype == torch.float32
    assert got.y.dtype == torch.int32
    assert float(got.x.min()) >= np.float32(1e-9) and float(got.x.max()) <= 1.0
    assert float(got.bdist.min()) >= 0.0 and float(got.bdist.max()) <= 1.0
    if name in TEMPORAL_NAMES:
        # x changes only inside the crop parcels; y and bdist never.
        np.testing.assert_array_equal(got.y.numpy(), np.asarray(batch.y))
        np.testing.assert_array_equal(got.bdist.numpy(), np.asarray(batch.bdist))
        outside = np.asarray(batch.y) != 1
        before = np.clip(np.asarray(batch.x), 1e-9, 1.0)
        after = got.x.numpy()
        for b in range(after.shape[0]):
            np.testing.assert_array_equal(
                after[b][:, outside[b]], before[b][:, outside[b]]
            )
        if name != "roll":
            assert not np.array_equal(after, before)


def _chips(root, num=12, seed=8):
    rng = np.random.default_rng(seed)
    for _ in range(num):
        batch = jax_create_batch(
            num_channels=3, num_time=12, height=20, width=20, rng=rng
        )
        batch.to_file(root / "processed" / batch.batch_id[0])
    return root


def test_dataset_augmentation_matches_jax(tmp_path, monkeypatch):
    """24 samples (two passes over 12 chips) at augment_prob 0.5: the same
    augmenter per sample, the same generator state after each, equal
    outputs where the augmenter is deterministic."""
    import cultionet_tpu.augment as jax_augment

    chosen = {"jax": [], "port": []}

    def recording(cls, log):
        class Recording(cls):
            def __init__(self, augmentations, **kwargs):
                log.extend(augmentations)
                super().__init__(augmentations, **kwargs)

        return Recording

    monkeypatch.setattr(
        jax_augment, "Augmenters", recording(JaxAugmenters, chosen["jax"])
    )
    monkeypatch.setattr(
        port_datasets, "Augmenters", recording(Augmenters, chosen["port"])
    )
    root = _chips(tmp_path)
    jax_ds = JaxDataset(root, augment_prob=0.5, random_seed=3)
    ds = ChipDataset(root, augment_prob=0.5, random_seed=3)
    assert ds.augmentations == jax_ds.augmentations
    compared = 0
    for i in list(range(len(ds))) * 2:
        n = len(chosen["port"])
        want, got = jax_ds[i], ds[i]
        assert chosen["port"] == chosen["jax"]
        assert ds.rng.bit_generator.state == jax_ds.rng.bit_generator.state
        name = chosen["port"][n] if len(chosen["port"]) > n else "none"
        if name in DETERMINISTIC:
            compared += 1
            for field in ("x", "y", "bdist", "lat", "lon"):
                np.testing.assert_allclose(
                    getattr(got, field).numpy(),
                    np.asarray(getattr(want, field)),
                    atol=1e-6, rtol=1e-6, err_msg=f"{i} {name} {field}",
                )
    assert 6 <= len(chosen["port"]) <= 18, chosen["port"]
    assert compared >= 12
    # The split carries the augmenters; validation never augments.
    train, val = ChipDataset(
        root, augment_prob=0.5, augmentations=["fliplr", "roll"]
    ).split_train_val(0.25)
    assert train.augmentations == ["fliplr", "roll"] and train.augment_prob == 0.5
    assert val.augmentations == ["fliplr", "roll"] and val.augment_prob == 0.0
    with pytest.raises(ValueError, match="Unknown"):
        Augmenters(["twist"])
