"""The port's device-resident train split (``data/device_cache.py``), its
train step (``train/step.py::make_hbm_train_step``) and
``fit(use_chipstore="hbm" | "auto")`` against the JAX package on the CPU.

- ``DeviceChipCache``'s int16 arrays equal JAX's bit for bit, for float
  chips in [0, 1] and int16 chips, and for float chips already on the
  x 10000 scale the records of a chipstore file, where JAX's cache wraps;
  its index batches equal JAX's for three epochs
  (with and without ``drop_remainder``); ``fits`` and
  ``estimate_cache_bytes`` agree at budgets around the estimate;
  ``skip_epochs(2)`` replays the third epoch; ``gather_batch`` equals the
  host stack.
- ``make_hbm_train_step`` equals ``make_train_step`` on the gathered batch
  exactly.
- ``fit(use_chipstore="hbm")`` for one epoch with weight averaging, from
  the same weights as JAX's ``fit`` in its "hbm" mode (fp32, dropout 0,
  int16 chips with normalization statistics, so the step dequantizes,
  clips and z-scores): per-epoch ``loss`` and ``val_loss`` within 1e-5, and
  the final parameters and BatchNorm statistics (the refit over the
  resident split's batches) within 1e-5 of the largest entry. The model is
  hidden 8 with no attention, T = 6 and 12 x 12 chips, so that JAX's fit
  compiles in about 20 s.
- A resumed "hbm" fit equals an uninterrupted one bit for bit; "auto"
  takes the resident split when it fits; ``use_latlon`` with a resident
  split raises ``ValueError`` in the port when the fit starts; JAX's
  resident batches carry no coordinates either, and its model's fusion
  block asserts on them (at JAX's first step).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cultionet_tpu.config import CultionetParams as JaxParams
from cultionet_tpu.data import ChipDataset as JaxDataset
from cultionet_tpu.data.batch import Batch as JaxBatch
from cultionet_tpu.data.device_cache import DeviceChipCache as JaxCache
from cultionet_tpu.data.device_cache import estimate_cache_bytes as jax_estimate
from cultionet_tpu.data.device_cache import gather_batch as jax_gather
from cultionet_tpu.models import CultioNet as JaxCultioNet
from cultionet_tpu.models.unet_parts import TowerUNetBlock
from cultionet_tpu.train import step as jax_step
from cultionet_tpu.train.fit import fit as jax_fit
from cultionet_tpu.utils.normalize import NormValues as JaxNormValues
from cultionet_tpu_torch.config import CultionetParams
from cultionet_tpu_torch.data import chipstore
from cultionet_tpu_torch.data.batch import Batch
from cultionet_tpu_torch.data.datasets import ChipDataset
from cultionet_tpu_torch.data.device_cache import (
    DeviceChipCache,
    estimate_cache_bytes,
    gather_batch,
    hbm_budget_bytes,
)
from cultionet_tpu_torch.models import CultioNet
from cultionet_tpu_torch.train import optim as torch_optim
from cultionet_tpu_torch.train import step as torch_step
from cultionet_tpu_torch.train.fit import fit
from cultionet_tpu_torch.utils.normalize import NormValues
from cultionet_tpu_torch.utils.params import from_flax, load_flax

from torch_port_helpers import seeded_variables, write_chip_files

MODEL = dict(hidden_channels=8, dilations=[1], attention_weights=None)
CONFIG = dict(
    val_frac=0.2,
    batch_size=2,
    epochs=1,
    learning_rate=1e-3,
    loss_name="TanimotoComplementLoss",
    precision="32",
    dropout=0.0,
    finetune="all",
    in_channels=3,
    in_time=6,
    **MODEL,
)
NORM = dict(
    dataset_mean=np.asarray([0.45, 0.5, 0.55], dtype=np.float32),
    dataset_std=np.asarray([0.25, 0.3, 0.28], dtype=np.float32),
    dataset_crop_counts=np.asarray([600, 300]),
    dataset_edge_counts=np.asarray([850, 50]),
    num_channels=3,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch CPU thread for this module: the test runner's workers
    share the cores, and torch's thread pool on these small tensors then
    slows down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def chips(tmp_path_factory):
    """10 chips of T = 6, 12 x 12, 3 bands, x and bdist int16 x 10000."""
    root = tmp_path_factory.mktemp("chips")
    write_chip_files(root, 10, seed=11, packed=True)
    return root


@pytest.fixture(scope="module")
def float_chips(tmp_path_factory):
    """7 chips as the synthetic generator makes them (float x and bdist)."""
    root = tmp_path_factory.mktemp("float_chips")
    write_chip_files(root, 7, seed=12, packed=False)
    return root


@pytest.mark.parametrize("which", ["chips", "float_chips"])
def test_arrays_match_jax(which, request):
    root = request.getfixturevalue(which)
    got = DeviceChipCache(ChipDataset(root), batch_size=2, device="cpu")
    want = JaxCache(JaxDataset(root), batch_size=2)
    assert got.num_chips == want.num_chips
    assert got.resident_bytes == want.resident_bytes
    for name in ("x", "y", "bdist"):
        value = got.arrays[name]
        assert value.dtype == torch.int16 and value.device.type == "cpu"
        np.testing.assert_array_equal(value.numpy(), np.asarray(want.arrays[name]))


def test_packed_float_chips_pack_as_the_chipstore_packs(tmp_path):
    """Float chips whose x is already on the x 10000 scale (as v1
    reference chips read): the resident arrays hold the records of a
    version-2 chipstore file of the same chips. JAX's cache scales that x
    by 10000 again, past the int16 range; this is where the port differs
    (ROADMAP section 3)."""
    rng = np.random.default_rng(13)
    for i in range(3):
        Batch(
            x=torch.from_numpy(
                np.round(rng.random((1, 6, 12, 12, 3)) * 10000).astype("float32")
            ),
            y=torch.from_numpy(rng.integers(-1, 3, (1, 12, 12)).astype("int32")),
            bdist=torch.from_numpy(rng.random((1, 12, 12), dtype=np.float32)),
        ).to_file(tmp_path / "processed" / f"data_{i}.npz")
    dataset = ChipDataset(tmp_path)
    cache = DeviceChipCache(dataset, batch_size=2, device="cpu")
    path = chipstore.build_chipstore_from_dataset(dataset, tmp_path / "t.cts")
    with chipstore.ChipStore(path) as store:
        records = store.read_batch(range(3))
    for name in ("x", "y", "bdist"):
        assert torch.equal(cache.arrays[name], getattr(records, name)), name
    x = Batch.from_file(dataset.files[0]).x
    assert torch.equal(cache.arrays["x"][0], x[0].to(torch.int16))
    jax_x = np.asarray(JaxCache(JaxDataset(tmp_path), batch_size=2).arrays["x"])
    assert not np.array_equal(jax_x, cache.arrays["x"].numpy())


@pytest.mark.parametrize("drop_remainder", [True, False])
def test_index_batches_match_jax(float_chips, drop_remainder):
    got = DeviceChipCache(
        ChipDataset(float_chips), batch_size=3, seed=5,
        drop_remainder=drop_remainder, device="cpu",
    )
    want = JaxCache(
        JaxDataset(float_chips), batch_size=3, seed=5,
        drop_remainder=drop_remainder,
    )
    assert len(got) == len(want) == (2 if drop_remainder else 3)
    for _ in range(3):
        ours = [b.indices.numpy() for b in got]
        theirs = [np.asarray(b.indices) for b in want]
        assert [b.tolist() for b in ours] == [b.tolist() for b in theirs]
        assert all(len(b) == 3 for b in ours)


def test_skip_epochs_replays_the_third_epoch(float_chips):
    def cache():
        return DeviceChipCache(
            ChipDataset(float_chips), batch_size=2, seed=9, device="cpu"
        )

    whole = cache()
    epochs = [[b.indices.tolist() for b in whole] for _ in range(3)]
    skipped = cache()
    skipped.skip_epochs(2)
    assert [b.indices.tolist() for b in skipped] == epochs[2]
    assert epochs[0] != epochs[2]


def test_fits_and_estimate_match_jax(float_chips):
    per_chip = estimate_cache_bytes(1, 6, 12, 12, 3)
    assert per_chip == jax_estimate(1, 6, 12, 12, 3) == 6 * 144 * 3 * 2 + 2 * 144 * 2
    need = estimate_cache_bytes(7, 6, 12, 12, 3)
    assert need == jax_estimate(7, 6, 12, 12, 3) == 7 * per_chip
    for budget in (need - 1, need, need + 1, 0):
        got = DeviceChipCache.fits(ChipDataset(float_chips), budget, device="cpu")
        assert got == JaxCache.fits(JaxDataset(float_chips), budget) == (
            budget >= need
        )
    assert hbm_budget_bytes(device="cpu") == int(16e9 * 0.5)
    assert DeviceChipCache.fits(ChipDataset(float_chips), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            hbm_budget_bytes()


def test_gather_equals_host_stack(chips):
    dataset = ChipDataset(chips)
    cache = DeviceChipCache(dataset, batch_size=2, device="cpu")
    idx = torch.tensor([4, 1, 4])
    batch = gather_batch(cache.arrays, idx)
    raw = [Batch.from_file(dataset.files[i]) for i in (4, 1, 4)]
    for name in ("x", "y", "bdist"):
        want = torch.cat([getattr(b, name) for b in raw]).to(torch.int16)
        assert torch.equal(getattr(batch, name), want), name
    assert batch.lat is None and batch.left is None


def test_hbm_step_equals_the_step_on_the_gathered_batch(chips):
    dataset = ChipDataset(chips)
    cache = DeviceChipCache(dataset, batch_size=2, device="cpu")
    model = CultioNet(in_time=6, dropout=0.2, **MODEL)
    kwargs = dict(
        loss_name="TanimotoComplementLoss",
        device_augment=True,
        device_augment_noise=0.01,
        norm_stats=(NORM["dataset_mean"], NORM["dataset_std"]),
        device="cpu",
    )
    states = [
        torch_step.create_train_state(
            CultioNet(in_time=6, dropout=0.2, **MODEL),
            torch_optim.build_optimizer("AdamW", 1e-3),
            device="cpu",
        )
        for _ in range(2)
    ]
    for state in states:
        state.model.load_state_dict(model.state_dict())
    hbm_step = torch_step.make_hbm_train_step(**kwargs)
    plain_step = torch_step.make_train_step(**kwargs)
    generators = [torch.Generator().manual_seed(4) for _ in range(2)]
    for index_batch in cache:
        _, got = hbm_step(states[0], cache.arrays, index_batch.indices, generators[0])
        _, want = plain_step(
            states[1], gather_batch(cache.arrays, index_batch.indices), generators[1]
        )
        assert all(torch.equal(got[k], want[k]) for k in want)
    for name, value in states[1].model.state_dict().items():
        assert torch.equal(states[0].model.state_dict()[name], value), name
    assert torch.equal(generators[0].get_state(), generators[1].get_state())


def _jax_pretrained():
    jax_model = JaxCultioNet(in_time=6, dropout=0.0, **MODEL)
    variables = seeded_variables(
        jax_model, JaxBatch(x=jnp.zeros((1, 6, 12, 12, 3))), training=False,
        seed=6,
    )
    state = jax_step.TrainState.create(
        apply_fn=jax_model.apply,
        params=variables["params"],
        batch_stats=variables["batch_stats"],
        tx=optax.sgd(0.0),
    )
    return state, variables


def test_hbm_fit_matches_jax(chips, tmp_path):
    pretrained, variables = _jax_pretrained()
    options = dict(use_chipstore="hbm", stochastic_weight_averaging=True)
    want = jax_fit(
        JaxParams(
            ckpt_file=tmp_path / "jax" / "last.ckpt",
            dataset=JaxDataset(chips, norm_values=JaxNormValues(**NORM)),
            **CONFIG,
            **options,
        ),
        pretrained_state=pretrained,
    )
    model = load_flax(CultioNet(in_time=6, dropout=0.0, **MODEL), variables)
    got = fit(
        CultionetParams(
            ckpt_file=tmp_path / "port" / "last.ckpt",
            dataset=ChipDataset(chips, norm_values=NormValues(**NORM)),
            **CONFIG,
            **options,
        ),
        pretrained_state=model.state_dict(),
        device="cpu",
    )
    assert len(got.history) == len(want.history) == 1
    for key in ("loss", "val_loss", "val_score"):
        np.testing.assert_allclose(
            got.history[0][key], want.history[0][key], atol=1e-5, rtol=0,
            err_msg=key,
        )
    assert got.state.step == 4
    want_state = from_flax(
        {"params": want.state.params, "batch_stats": want.state.batch_stats}
    )
    state = got.state.model.state_dict()
    top = max(float(v.abs().max()) for v in want_state.values())
    for name, value in want_state.items():
        diff = float((state[name] - value).abs().max())
        assert diff <= 1e-5 * top, (name, diff, top)
    # The resident split builds no chipstore file.
    assert not list((tmp_path / "port").glob("*.cts"))


def _port_run(chips, ckpt: Path, **options):
    params = CultionetParams(
        ckpt_file=ckpt / "last.ckpt",
        dataset=ChipDataset(chips, norm_values=NormValues(**NORM)),
        **{**CONFIG, "dropout": 0.2, **options},
    )
    return fit(params, device="cpu")


def test_hbm_resume_equals_uninterrupted(chips, tmp_path):
    """At dropout 0.2 with in-step augmentation, and a learning-rate
    schedule that does not depend on the number of epochs."""
    options = dict(
        use_chipstore="hbm", device_augment=True, device_augment_noise=0.01,
        lr_scheduler="ExponentialLR",
    )
    _port_run(chips, tmp_path / "a", epochs=2, **options)
    resumed = _port_run(chips, tmp_path / "a", epochs=3, **options)
    whole = _port_run(chips, tmp_path / "b", epochs=3, **options)
    assert [r["epoch"] for r in resumed.history] == [2]
    assert resumed.history[0] == whole.history[2]
    assert resumed.state.step == whole.state.step == 12
    got, want = resumed.state.model.state_dict(), whole.state.model.state_dict()
    for name, value in want.items():
        assert torch.equal(got[name], value), name


def test_auto_takes_the_resident_split(chips, tmp_path, caplog):
    with caplog.at_level("INFO", logger="cultionet_tpu_torch.train.fit"):
        result = _port_run(chips, tmp_path, use_chipstore="auto")
    assert result.state.step == 4
    assert "device-resident dataset: 8 chips" in caplog.text
    assert not list(tmp_path.glob("*.cts"))


@pytest.mark.parametrize("mode", ["hbm", "auto"])
def test_latlon_with_a_resident_split_raises(chips, tmp_path, mode):
    with pytest.raises(ValueError, match="use_latlon"):
        _port_run(chips, tmp_path, use_chipstore=mode, use_latlon=True)
    assert not (tmp_path / "history.csv").exists()
    if mode == "hbm":
        # JAX's resident batches carry no coordinates either, and its
        # model's fusion block asserts on them at the first step.
        cache = JaxCache(JaxDataset(chips), batch_size=2)
        batch = jax_gather(cache.arrays, jnp.asarray([0, 1]))
        assert batch.lat is None and batch.lon is None
        block = TowerUNetBlock(up_channels=4, out_channels=4, use_latlon=True)
        side = jnp.zeros((2, 6, 6, 4))
        with pytest.raises(AssertionError, match="lat/lon"):
            block.init(jax.random.PRNGKey(0), side, side, side, side)
