"""The port's U-TAE (``models/utae.py``) and its train path, on the CPU,
against the plain reference ``tests/utae_reference.py`` (no JAX
counterpart: the JAX package has no U-TAE).

- Logits, the cross-entropy loss and every parameter's gradient of one
  training-mode step (dropout on, the same masks drawn on both sides) at
  the published widths on 32 x 32 chips with padded dates: in fp64, where
  round-off cannot hide a wrong term (tolerances and their reasons in the
  tests), and the forward in fp32. The port computes every date and zeroes
  the pads; the reference encodes only the real dates, the published way.
- Pad dates get zero attention and zero aggregation weight: what a pad
  date holds (image and day) leaves the logits bit for bit as they were.
- ``fit(model_type="UTAE")`` trains through the host loader (dated chips
  of different T padded by ``collate``) and through "hbm"
  (``DeviceChipCache`` pads the split to its most dates), reports the
  loss, OA and mIoU, saves a checkpoint that ``load_model`` rebuilds, and
  counts date and pad images; the command line's ``--model-type UTAE``
  reaches it.
- OA and mIoU against U-TAE's ``IoU.get_miou_acc`` in numpy; the constant
  learning rate and Adam's update against the reference's Adam.
"""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

import utae_reference as ref_module
from cultionet_tpu_torch.config import CultionetParams
from cultionet_tpu_torch.data.batch import Batch
from cultionet_tpu_torch.data.datasets import ChipDataset
from cultionet_tpu_torch.enums import InferenceNames, LossTypes
from cultionet_tpu_torch.models import UTAE, create_model
from cultionet_tpu_torch.models import utae as utae_module
from cultionet_tpu_torch.nn.dropout import dropout_rng
from cultionet_tpu_torch.train.metrics import class_scores
from cultionet_tpu_torch.train.optim import build_optimizer, build_schedule
from cultionet_tpu_torch.train.step import calc_loss, forward_loss
from cultionet_tpu_torch.utils import profiling
from cultionet_tpu_torch.utils.normalize import NormValues

B, T_DATES, SIZE, BANDS = 2, 5, 32, 10


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def seeded_pair(seed: int = 0):
    """The reference and the port's U-TAE at the published widths with the
    same seeded state: He-normal convolutions and linear layers, biases
    and norm shifts N(0, 0.1), norm scales N(1, 0.1), running variances
    at or above 1."""
    torch.manual_seed(seed)
    ref = ref_module.UTAE(input_dim=BANDS)
    generator = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, value in ref.state_dict().items():
            if not value.is_floating_point():
                continue
            draw = torch.randn(value.shape, generator=generator)
            if "running_var" in name:
                value.copy_(1.0 + draw.abs())
            elif value.dim() >= 2:
                # A transposed convolution's weight is (in, out, kh, kw).
                transposed = "up.0" in name
                fan_in = value.shape[0] * value[0, 0].numel() if transposed else value[0].numel()
                value.copy_(draw * math.sqrt(2.0 / fan_in))
            elif name.endswith("weight"):
                value.copy_(1.0 + 0.1 * draw)
            else:
                value.copy_(0.1 * draw)
    port = UTAE(in_channels=BANDS)
    port.load_state_dict(ref.state_dict())
    return ref, port


def dated_inputs(seed: int = 1):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, T_DATES, SIZE, SIZE, BANDS), generator=g)
    count = torch.tensor([T_DATES, 3])
    dates = torch.sort(torch.randint(0, 430, (B, T_DATES), generator=g), dim=1).values
    y = torch.randint(0, 20, (B, SIZE, SIZE), generator=g)
    return x, dates, count, y


def reference_step(ref, x, dates, count, y, seed):
    pad = torch.arange(T_DATES)[None] >= count[:, None]
    ref.train()
    ref.zero_grad()
    with ref_module.dropout_rng(torch.Generator().manual_seed(seed)):
        logits = ref(x.permute(0, 1, 4, 2, 3), dates, pad)
    loss = ref_module.loss(logits, y)
    loss.backward()
    return logits.detach(), loss.detach(), {n: p.grad for n, p in ref.named_parameters()}


def test_logits_loss_and_gradients_match_reference():
    """In fp64, the port's training-mode forward, the train step's
    objective (``calc_loss``) and the backward against the reference's. A random
    network with ten norm layers over batches of 32 to 128 samples (the
    decoder's BatchNorm at B 2) amplifies round-off some 1e4 times in the
    gradients (in fp32 they differ by up to 4%, in fp64 by ~1e-12), so the
    gradients are held in fp64: each leaf within 1e-8 of its largest
    entry, plus 1e-10 of the largest entry of any leaf for the leaves whose
    gradient is zero but for round-off (a bias before a norm layer; the
    keys' bias, which shifts every score of a head alike)."""
    ref, port = seeded_pair()
    ref.double()
    port.double()
    x, dates, count, y = dated_inputs()
    x = x.double()
    want_logits, want_loss, want_grads = reference_step(ref, x, dates, count, y, seed=7)

    port.train()
    with dropout_rng(torch.Generator().manual_seed(7)):
        outputs = port(x, dates=dates, date_count=count)
    logits = outputs[InferenceNames.CROP_TYPE]
    gap = (logits.permute(0, 3, 1, 2).detach() - want_logits).abs().max()
    assert gap <= 1e-10 * want_logits.abs().max()
    loss, report = calc_loss(
        outputs, Batch(x=x, y=y), loss_name=LossTypes.CROSS_ENTROPY
    )
    assert report == {} and loss.dtype == torch.float64
    assert abs(loss.item() - want_loss.item()) <= 1e-12 * abs(want_loss.item())
    loss.backward()
    grads = dict(port.named_parameters())
    assert set(grads) == set(want_grads)
    largest = max(g.abs().max() for g in want_grads.values())
    for name, want in want_grads.items():
        got = grads[name].grad
        assert got is not None, name
        limit = 1e-8 * want.abs().max() + 1e-10 * largest
        assert (got - want).abs().max() <= limit, name


def test_fp32_forward_matches_reference():
    """The fp32 forward and the train step's ``forward_loss``: the orders of
    summation apart, the logits within 2e-4 of their largest entry
    (measured 3e-5) and the loss within 1e-5 (measured 0)."""
    ref, port = seeded_pair()
    x, dates, count, y = dated_inputs()
    want_logits, want_loss, _ = reference_step(ref, x, dates, count, y, seed=9)
    port.train()
    with torch.no_grad(), dropout_rng(torch.Generator().manual_seed(9)):
        logits = port(x, dates=dates, date_count=count)[InferenceNames.CROP_TYPE]
    logits = logits.permute(0, 3, 1, 2)
    assert (logits - want_logits).abs().max() <= 2e-4 * want_logits.abs().max()
    with torch.no_grad():
        loss, _ = forward_loss(
            port, Batch(x=x, y=y, dates=dates, date_count=count),
            torch.Generator().manual_seed(9), torch.float32,
            loss_name=LossTypes.CROSS_ENTROPY,
        )
    assert abs(loss.item() - want_loss.item()) <= 1e-5 * abs(want_loss.item())


def test_pad_dates_get_zero_weight():
    _, port = seeded_pair()
    port.eval()
    x, dates, count, _ = dated_inputs()
    seen = []
    hook = port.temporal_encoder.register_forward_hook(lambda m, a, out: seen.append(out[1]))
    with torch.no_grad():
        first = port(x, dates=dates, date_count=count)[InferenceNames.CROP_TYPE]
        # Another image and another day at every pad date.
        x2, dates2 = x.clone(), dates.clone()
        x2[1, 3:] = 50.0 * torch.randn_like(x2[1, 3:])
        dates2[1, 3:] = 7
        second = port(x2, dates=dates2, date_count=count)[InferenceNames.CROP_TYPE]
    hook.remove()
    attn = seen[0]  # (heads, B, T, h, w)
    assert torch.all(attn[:, 1, 3:] == 0)
    assert torch.allclose(attn.sum(2), torch.ones(()), atol=1e-5)
    assert torch.equal(first, second)
    # The aggregation alone: pad dates weigh 0 even with nonzero weights.
    valid = utae_module.date_mask(count, T_DATES, B, "cpu")
    level = torch.randn(B, T_DATES, 64, 8, 8)
    weights = torch.rand(16, B, T_DATES, 4, 4)
    changed = level.clone()
    changed[1, 3:] = 1e3
    assert torch.equal(
        utae_module.aggregate(level, weights, valid),
        utae_module.aggregate(changed, weights, valid),
    )


def published_miou_acc(cm: np.ndarray, ignore_index: int):
    """``IoU.get_miou_acc`` of utae-paps ``src/learning/miou.py``."""
    cm = cm.astype(np.float64).copy()
    cm[:, ignore_index] = 0
    cm[ignore_index, :] = 0
    tp = np.diag(cm)
    fp = cm.sum(0) - tp
    fn = cm.sum(1) - tp
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = tp / (tp + fp + fn)
    return float(np.nanmean(iou)), float(tp.sum() / cm.sum())


def test_oa_and_miou_follow_the_published_meter():
    rng = np.random.default_rng(3)
    cm = rng.integers(0, 50, size=(20, 20))
    cm[4, :] = 0
    cm[:, 4] = 0  # a class absent from targets and predictions
    miou, acc = published_miou_acc(cm, 19)
    oa, got = class_scores(torch.from_numpy(cm).float())
    assert abs(float(got) - miou) < 1e-6 and abs(float(oa) - acc) < 1e-6


def test_fewer_classes_keep_void_as_the_last_logit():
    """A U-TAE whose head ends at K = 5 classes: under ``CrossEntropyLoss``
    its last logit is void, whatever K, as U-TAE's ``ignore_index`` -1:
    labels K - 1 and -1 weigh 0, every other class 1, and the confusion
    matrix stays (K, K)."""
    from cultionet_tpu_torch.train.step import evaluate_predictions

    torch.manual_seed(0)
    port = UTAE(in_channels=BANDS, out_conv=[32, 5])
    port.eval()
    x, dates, count, _ = dated_inputs()
    y = torch.randint(-1, 5, (B, SIZE, SIZE), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        outputs = port(x, dates=dates, date_count=count)
    logits = outputs[InferenceNames.CROP_TYPE]
    assert logits.shape[-1] == 5
    loss, _ = calc_loss(outputs, Batch(x=x, y=y), loss_name=LossTypes.CROSS_ENTROPY)
    per_pixel = torch.nn.functional.cross_entropy(
        logits.permute(0, 3, 1, 2), y.clamp(min=0).long(), reduction="none")
    keep = (y >= 0) & (y < 4)
    torch.testing.assert_close(loss, per_pixel[keep].mean(), rtol=1e-6, atol=0)
    out = evaluate_predictions(outputs, Batch(x=x, y=y), loss_name=LossTypes.CROSS_ENTROPY)
    assert out["confusion"].shape == (5, 5)
    assert float(out["confusion"][4].sum()) == float(((y == 4) | (y < 0)).sum())


def test_constant_rate_and_adam_follow_the_reference():
    schedule = build_schedule("Constant", 1e-3, epochs=100, steps_per_epoch=128)
    assert {schedule(s) for s in (0, 1, 5000, 12800, 10**6)} == {1e-3}
    g = torch.Generator().manual_seed(0)
    params = [torch.randn(5, 3, generator=g), torch.randn(7, generator=g)]
    mine = [p.clone() for p in params]
    theirs = [p.clone() for p in params]
    opt = build_optimizer("Adam", schedule, weight_decay=0.0, eps=1e-8).init(mine)
    adam = ref_module.Adam(theirs, lr=1e-3, eps=1e-8)
    for _ in range(3):
        grads = [torch.randn(p.shape, generator=g) for p in params]
        for p, grad in zip(mine, grads):
            p.grad = grad.clone()
        opt.step()
        adam.step(grads)
    for a, b in zip(mine, theirs):
        assert torch.allclose(a, b, atol=1e-7, rtol=0)


def write_dated_chips(directory: Path, count: int, seed: int = 0):
    """Dated int16 chips of 4 to 6 dates (unpadded), 20-class labels."""
    rng = np.random.default_rng(seed)
    directory.mkdir(parents=True, exist_ok=True)
    files = []
    for i in range(count):
        steps = int(rng.integers(4, 7))
        chip = Batch(
            x=torch.from_numpy(rng.integers(0, 10000, (1, steps, 16, 16, BANDS)).astype(np.int16)),
            y=torch.from_numpy(rng.integers(0, 20, (1, 16, 16)).astype(np.int16)),
            dates=torch.from_numpy(
                np.sort(rng.choice(430, steps, replace=False))[None].astype(np.int16)
            ),
            date_count=torch.tensor([steps], dtype=torch.int16),
        )
        path = directory / f"data_{i:03d}.npz"
        chip.to_file(path, compression="none")
        files.append(path)
    return files


def utae_params(dataset, **changes) -> CultionetParams:
    kwargs = dict(
        dataset=dataset, model_type="UTAE", loss_name=LossTypes.CROSS_ENTROPY,
        optimizer="Adam", learning_rate=1e-3, lr_scheduler="Constant", weight_decay=0.0,
        eps=1e-8, gradient_clip_val=None, batch_size=2, epochs=1, precision="32",
        val_frac=0.3, random_seed=5, hidden_channels=64,
    )
    kwargs.update(changes)
    return CultionetParams(**kwargs)


@pytest.mark.parametrize("mode", ["host", "hbm"])
def test_fit_trains_utae(tmp_path, mode):
    from cultionet_tpu_torch.model import load_model
    from cultionet_tpu_torch.train.fit import fit

    files = write_dated_chips(tmp_path / "chips", 7)
    norm = NormValues(np.full(BANDS, 0.5, np.float32), np.full(BANDS, 0.3, np.float32),
                      np.zeros(2), np.zeros(2), BANDS)
    dataset = ChipDataset(tmp_path / "chips", files=files, norm_values=norm, random_seed=5)
    params = utae_params(
        dataset, use_chipstore="hbm" if mode == "hbm" else False,
        ckpt_file=tmp_path / "ckpt" / "last.ckpt",
    )
    before = dict(profiling.COUNTS)
    result = fit(params, device="cpu")
    row = result.history[-1]
    assert set(row) == {"epoch", "loss", "val_loss", "val_score", "voa", "vmiou", "lr_sch"}
    assert np.isfinite(row["loss"]) and np.isfinite(row["val_loss"])
    assert 0.0 <= row["voa"] <= 1.0 and 0.0 <= row["vmiou"] <= 1.0
    assert row["val_score"] == pytest.approx(1.0 - row["vmiou"])
    assert row["lr_sch"] == pytest.approx(1e-3)
    assert result.state.step == result.steps_per_epoch == 2
    dates = profiling.COUNTS["utae_date_images"] - before["utae_date_images"]
    pads = profiling.COUNTS["utae_pad_images"] - before["utae_pad_images"]
    assert dates > 0 and 0 < pads < dates
    _, model = load_model(tmp_path / "ckpt" / "last_store", which="last", device="cpu")
    assert isinstance(model, UTAE)
    for name, value in result.state.model.state_dict().items():
        assert torch.equal(model.state_dict()[name], value), name


def test_fit_refuses_the_towerunet_loss(tmp_path):
    from cultionet_tpu_torch.train.fit import fit

    dataset = ChipDataset(tmp_path, files=write_dated_chips(tmp_path / "c", 3))
    with pytest.raises(ValueError, match="CrossEntropyLoss"):
        fit(utae_params(dataset, loss_name=LossTypes.TANIMOTO_COMPLEMENT), device="cpu")
    with pytest.raises(ValueError, match="encoder_widths"):
        create_model(BANDS, model_type="UTAE", hidden_channels=32)


def test_cli_model_type_reaches_fit(tmp_path):
    from cultionet_tpu_torch.scripts.cli import main

    project = tmp_path / "project"
    write_dated_chips(project / "data" / "train" / "processed", 6, seed=3)
    main(
        ["train", "-p", str(project), "--model-type", "UTAE", "--loss-name",
         "CrossEntropyLoss", "--optimizer", "Adam", "--learning-rate", "0.001",
         "--lr-scheduler", "Constant", "--weight-decay", "0", "--epochs", "1",
         "--batch-size", "2", "--val-frac", "0.34", "--precision", "32",
         "--augment-prob", "0.0"],
        device="cpu",
    )
    history = (project / "ckpt" / "history.csv").read_text().splitlines()
    assert history[0].split(",") == ["epoch", "loss", "val_loss", "val_score", "voa",
                                      "vmiou", "lr_sch"]
    assert len(history) == 2
