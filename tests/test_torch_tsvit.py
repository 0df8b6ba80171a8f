"""The port's TSViT (``models/tsvit.py``) and its train path, on the CPU,
against the benchmark's plain reference ``portbench/reference/tsvit.py``
(no JAX counterpart: the JAX package has no TSViT).

- At a small size (8 x 8 chips, patch 2, 6 dates, 5 classes, width 32,
  two temporal and two spatial layers) on seeded weights: the logits,
  the loss and the gradient of every leaf match the reference's; three
  ``make_train_step`` steps (Adam, the cosine schedule) give the
  reference's losses and changes.
- ``create_model(model_type="TSViT")`` builds the published PASTIS24
  widths; ``fit(model_type="TSViT")`` trains through "hbm" and reports
  the loss, OA and mIoU with void left out.
- The day-of-year mapping and the head's unpatchify; the masked loss
  leaves void and unlabeled pixels out.
- Neither the model nor the reference loads JAX.
"""

import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cultionet_tpu_torch.config import CultionetParams
from cultionet_tpu_torch.data.batch import Batch
from cultionet_tpu_torch.data.datasets import ChipDataset
from cultionet_tpu_torch.enums import InferenceNames, LossTypes
from cultionet_tpu_torch.losses import CrossEntropyLoss, MaskedCrossEntropyLoss
from cultionet_tpu_torch.models import TSViT, create_model
from cultionet_tpu_torch.models import tsvit as tsvit_module
from cultionet_tpu_torch.train.optim import build_optimizer, build_schedule
from cultionet_tpu_torch.train.step import (
    calc_loss, create_train_state, make_train_step,
)
from cultionet_tpu_torch.utils.normalize import NormValues
from portbench.reference import tsvit as ref_module

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(img_res=8, patch_size=2, num_classes=5, dim=32, temporal_depth=2,
             spatial_depth=2, heads=4, dim_head=8, scale_dim=4)
B, T_DATES, BANDS = 3, 6, 10


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def seeded_pair(seed: int = 0):
    """The reference and the port at ``SMALL`` with one seeded state:
    linear weights N(0, 1 / fan-in), biases N(0, 0.1), LayerNorm scales
    N(1, 0.1), the tokens and position embeddings N(0, 1)."""
    g = torch.Generator().manual_seed(seed)
    ref = ref_module.TSViT(in_channels=BANDS, **SMALL)
    with torch.no_grad():
        for name, p in ref.named_parameters():
            draw = torch.randn(p.shape, generator=g)
            if name.endswith("bias"):
                p.copy_(0.1 * draw)
            elif p.dim() == 1:
                p.copy_(1.0 + 0.1 * draw)
            elif name.endswith("weight"):
                p.copy_(draw / math.sqrt(p.shape[1]))
            else:
                p.copy_(draw)
    port = TSViT(in_channels=BANDS, hidden_channels=SMALL["dim"], **SMALL)
    port.load_state_dict(ref.state_dict())
    return ref, port


def dated_inputs(seed: int = 1):
    """z-scored-like x (B, T, 8, 8, 10), days, 3 to 6 real dates, labels
    in 0..6 (5 and 6 outside the 5 classes: void)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, T_DATES, 8, 8, BANDS, generator=g)
    count = torch.tensor([6, 3, 4])
    days = torch.sort(torch.randint(0, 430, (B, T_DATES), generator=g), dim=1).values
    y = torch.randint(0, 7, (B, 8, 8), generator=g)
    return x, days, count, y


def masked(x, count):
    real = torch.arange(x.shape[1])[None] < count[:, None]
    return x * real[:, :, None, None, None]


def test_parameter_names_match_the_reference():
    ref, port = seeded_pair()
    assert list(dict(ref.named_parameters())) == list(dict(port.named_parameters()))


@pytest.mark.parametrize("grad", [True, False], ids=["train", "eval"])
def test_every_layernorm_goes_through_layer_norm_rows(monkeypatch, grad):
    """Each of the 2 x 2 + 1 LayerNorms of an encoder and the head's calls
    ``layer_norm_rows`` once a forward, with and without a gradient, on the
    parameters of its ``nn.LayerNorm`` (its names unchanged), and the
    forward equals the one through the modules bit for bit."""
    from torch import nn

    _, port = seeded_pair()
    norms = {id(m.weight): m for m in port.modules() if isinstance(m, nn.LayerNorm)}
    assert len(norms) == 11
    assert sum(1 for n, _ in port.named_parameters() if n.endswith("norm.weight")) == 10
    x = torch.randn(B, T_DATES, 8, 8, BANDS, generator=torch.Generator().manual_seed(1))
    calls = []
    original = tsvit_module.layer_norm_rows

    def counted(t, weight, bias, eps):
        calls.append(id(weight))
        return original(t, weight, bias, eps)

    monkeypatch.setattr(tsvit_module, "layer_norm_rows", counted)
    with torch.set_grad_enabled(grad):
        got = port(x)[InferenceNames.CROP_TYPE]
    assert sorted(calls) == sorted(norms)
    monkeypatch.setattr(tsvit_module, "layer_norm_rows",
                        lambda t, weight, bias, eps: norms[id(weight)](t))
    with torch.set_grad_enabled(grad):
        want = port(x)[InferenceNames.CROP_TYPE]
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_logits_loss_and_gradients_match_reference():
    """fp32 on both sides; rtol 1e-5 with an absolute floor of 1e-5 of
    the largest entry: the port scales q before its product and runs the
    spatial attention through SDPA, the reference scales the products, so
    the two round differently (measured: at most 8e-7 of a leaf's largest
    entry). The floor of a gradient is 1e-5 of the largest entry of any
    leaf: the head's biases shift every class's logit alike, so their
    exact gradient is 0 and each side's is round-off. Pad dates hold other
    values on the port's side (it zeroes them itself)."""
    ref, port = seeded_pair()
    x, days, count, y = dated_inputs()
    want = ref(masked(x, count), ref_module.day_of_year(days, count))
    want_loss = ref_module.loss(want, y)
    want_loss.backward()
    x_pads = x + (1 - (torch.arange(T_DATES)[None] < count[:, None]).float())[..., None, None, None]
    out = port(x_pads, None, None, days, count)[InferenceNames.CROP_TYPE]
    got = out.permute(0, 3, 1, 2)

    def close(a, b):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))

    close(got, want.detach())
    loss, report = calc_loss({InferenceNames.CROP_TYPE: out}, Batch(x=x, y=y),
                             loss_name=LossTypes.MASKED_CROSS_ENTROPY)
    assert report == {}
    close(loss, want_loss.detach())
    loss.backward()
    grads = {name: p.grad for name, p in ref.named_parameters()}
    floor = 1e-5 * max(float(g.abs().max()) for g in grads.values())
    for name, p in port.named_parameters():
        assert p.grad is not None, name
        torch.testing.assert_close(p.grad, grads[name], rtol=1e-5, atol=floor)


def test_three_train_steps_match_reference():
    """``make_train_step`` (fp32, Adam at the cosine schedule, the z-score
    of int16 records) against ``TSViTTrainer`` for three steps: each loss
    within 1e-5 of the reference's, and each leaf's change after the three
    steps within 1e-4 of the reference's change by norm. Adam moves an
    element by about the rate whatever the size of its gradient, so an
    element whose gradient is near 0 carries the forward's round-off (as
    above) into its change almost whole (measured: 7e-6 of a change of
    about 3e-3 in one element of 4,096); the leaves whose first gradient
    is round-off (the head's biases, as above) move by the rate in either
    direction and are left out, as the benchmark's ``change_gap`` leaves
    them out."""
    ref, port = seeded_pair(seed=3)
    before = {name: p.detach().clone() for name, p in ref.named_parameters()}
    mean, std = np.full(BANDS, 0.5, np.float32), np.full(BANDS, 0.25, np.float32)
    schedule = build_schedule("CosineAnnealingLR", learning_rate=1e-3, epochs=100,
                              steps_per_epoch=2)
    state = create_train_state(port, build_optimizer("Adam", schedule), device="cpu")
    state.optimizer = build_optimizer("Adam", schedule, weight_decay=0.0, eps=1e-8).init(
        state.model.parameters())
    step = make_train_step(loss_name=LossTypes.MASKED_CROSS_ENTROPY, precision="fp32", device="cpu",
                           norm_stats=(mean, std))
    trainer = ref_module.TSViTTrainer(ref, ref_module.cosine_lr(1e-3, 2), eps=1e-8)
    generator = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(4)
    for i in range(3):
        _, days, count, y = dated_inputs(seed=10 + i)
        raw = rng.integers(0, 10000, (B, T_DATES, 8, 8, BANDS)).astype(np.int16)
        raw = raw * (np.arange(T_DATES)[None] < count.numpy()[:, None])[..., None, None, None]
        batch = Batch(x=torch.from_numpy(raw.astype(np.int16)), y=y, dates=days,
                      date_count=count)
        state, logs = step(state, batch, generator)
        x = (torch.from_numpy(raw).float() / 10000.0).clamp(1e-9, 1.0)
        x = masked((x - torch.from_numpy(mean)) / torch.from_numpy(std), count)
        want = trainer.step(x, ref_module.day_of_year(days, count), y)
        assert abs(float(logs["loss"]) - want) <= 1e-5 * abs(want)
    first = {name: float(g.norm()) for name, g in trainer.first_grads.items()}
    median = float(np.median(list(first.values())))
    theirs = dict(ref.named_parameters())
    moved = 0
    for name, p in state.model.named_parameters():
        if first[name] < 1e-3 * median:
            continue
        want = theirs[name].detach() - before[name]
        gap = float((p.detach() - before[name] - want).norm() / want.norm())
        assert gap <= 1e-4, (name, gap)
        moved += 1
    assert moved == len(first) - 2  # all but the head's two biases


def test_create_model_builds_the_published_widths():
    model = create_model(10, model_type="TSViT", in_time=60, hidden_channels=128)
    assert isinstance(model, TSViT)
    # 8 layers of 197,888 (two LayerNorms, qkv 128 x 384, out 128 x 128 +
    # 128, FF 128 x 512 + 512 and 512 x 128 + 128), two final norms, the
    # patch embedding 40 x 128 + 128, the date embedding 366 x 128 + 128,
    # 19 class tokens, 144 positions, the head's norm and 128 x 4 + 4.
    count = 8 * 197_888 + 512 + 5_248 + 46_976 + 19 * 128 + 144 * 128 + 256 + 516
    assert sum(p.numel() for p in model.parameters()) == count == 1_657_476
    with pytest.raises(ValueError, match="must equal dim"):
        create_model(10, model_type="TSViT", hidden_channels=64)


def test_day_of_year_and_unpatchify():
    days = torch.tensor([[0, 121, 122, 429, 7, 9]])
    valid = torch.tensor([[True, True, True, True, False, False]])
    assert tsvit_module.day_of_year(days, valid).tolist() == [[243, 364, 0, 307, 0, 0]]
    assert torch.equal(ref_module.day_of_year(days, torch.tensor([4])),
                       tsvit_module.day_of_year(days, valid))
    # A one-band, one-class image through patchify and back.
    image = torch.arange(2 * 8 * 8, dtype=torch.float32).reshape(2, 1, 8, 8, 1)
    patches = tsvit_module.patchify(image, 2)  # (2 * 16, 1, 4)
    assert torch.equal(patches[1, 0], torch.tensor([2.0, 3.0, 10.0, 11.0]))
    back = tsvit_module.unpatchify(patches.reshape(2, 16, 4), 2, 1, 4, 4, 2)
    assert torch.equal(back, image[:, 0])


def test_loss_leaves_void_out_where_there_is_no_void_logit():
    g = torch.Generator().manual_seed(2)
    logits = torch.randn(2, 4, 4, 5, generator=g)
    y = torch.randint(-1, 8, (2, 4, 4), generator=g)
    got = MaskedCrossEntropyLoss()(logits, y)
    want = ref_module.loss(logits.permute(0, 3, 1, 2), y)
    assert torch.allclose(got, want, rtol=1e-6, atol=0)
    # U-TAE's loss, at any K, keeps its last logit for void at weight 0.
    per_pixel = torch.nn.functional.cross_entropy(
        logits.permute(0, 3, 1, 2), y.clamp(0, 4).long(), reduction="none")
    keep = (y >= 0) & (y < 4)
    assert torch.allclose(CrossEntropyLoss()(logits, y), per_pixel[keep].mean(), rtol=1e-6)


def write_tiles(directory: Path, count: int, seed: int = 0):
    """Dated int16 24 x 24 tiles of 4 to 6 dates, PASTIS labels 0-19."""
    rng = np.random.default_rng(seed)
    directory.mkdir(parents=True, exist_ok=True)
    files = []
    for i in range(count):
        steps = int(rng.integers(4, 7))
        chip = Batch(
            x=torch.from_numpy(rng.integers(0, 10000, (1, steps, 24, 24, BANDS)).astype(np.int16)),
            y=torch.from_numpy(rng.integers(0, 20, (1, 24, 24)).astype(np.int16)),
            dates=torch.from_numpy(
                np.sort(rng.choice(430, steps, replace=False))[None].astype(np.int16)),
            date_count=torch.tensor([steps], dtype=torch.int16),
        )
        path = directory / f"data_{i:03d}.npz"
        chip.to_file(path, compression="none")
        files.append(path)
    return files


def test_fit_trains_tsvit_through_hbm(tmp_path):
    from cultionet_tpu_torch.model import load_model
    from cultionet_tpu_torch.train.fit import fit

    files = write_tiles(tmp_path / "chips", 6)
    norm = NormValues(np.full(BANDS, 0.5, np.float32), np.full(BANDS, 0.3, np.float32),
                      np.zeros(2), np.zeros(2), BANDS)
    dataset = ChipDataset(tmp_path / "chips", files=files, norm_values=norm, random_seed=5)
    params = CultionetParams(
        dataset=dataset, model_type="TSViT", loss_name=LossTypes.MASKED_CROSS_ENTROPY,
        optimizer="Adam", learning_rate=1e-3, lr_scheduler="CosineAnnealingLR",
        weight_decay=0.0, eps=1e-8, gradient_clip_val=None, batch_size=2, epochs=1,
        precision="32", val_frac=0.3, random_seed=5, hidden_channels=128,
        use_chipstore="hbm", ckpt_file=tmp_path / "ckpt" / "last.ckpt",
    )
    result = fit(params, device="cpu")
    row = result.history[-1]
    assert np.isfinite(row["loss"]) and np.isfinite(row["val_loss"])
    assert 0.0 <= row["voa"] <= 1.0 and 0.0 <= row["vmiou"] <= 1.0
    assert result.state.step == result.steps_per_epoch == 2
    _, model = load_model(tmp_path / "ckpt" / "last_store", which="last", device="cpu")
    assert isinstance(model, TSViT)


def test_confusion_puts_void_in_an_added_row():
    from cultionet_tpu_torch.train.step import evaluate_predictions

    logits = torch.zeros(1, 2, 2, 5)
    logits[..., 1] = 1.0  # every pixel predicted class 1
    y = torch.tensor([[[1, 19], [-1, 4]]])
    out = evaluate_predictions({InferenceNames.CROP_TYPE: logits}, Batch(x=None, y=y),
                               loss_name=LossTypes.MASKED_CROSS_ENTROPY)
    cm = out["confusion"]
    assert cm.shape == (6, 6) and cm[1, 1] == 1 and cm[4, 1] == 1 and cm[5, 1] == 2


def test_model_and_reference_load_no_jax():
    code = (
        "import sys\n"
        "import cultionet_tpu_torch.models.tsvit, portbench.reference.tsvit\n"
        "loaded = {n.split('.')[0] for n in sys.modules}\n"
        "print(sorted(loaded & {'jax', 'jaxlib', 'cultionet_tpu'}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_kernel_plans_at_the_two_attention_sites():
    """PASTIS24 at batch 16: the temporal site (S = 79, q, k and v the thirds
    of one projection) plans one sequence a block, forward and backward;
    the spatial site (S = 144) plans a forward, but no backward fits a
    block, which is why the spatial encoder runs on SDPA."""
    from cultionet_tpu_torch.ops import temporal_cuda as tc

    n, c, heads = 16 * 144, 128, 4
    forward = tc._tile_plan(n, 79, 79, c, heads, 2, False, fused=True)
    backward = tc._tile_plan(n, 79, 79, c, heads, 2, True, fused=True)
    assert (forward.pixels, forward.smem, forward.blocks_per_sm) == (1, 146_928, 1)
    assert (backward.pixels, backward.smem, backward.blocks_per_sm) == (1, 185_248, 1)
    spatial = 16 * 19
    assert tc._tile_plan(spatial, 144, 144, c, heads, 2, False, fused=True).smem == 152_064
    with pytest.raises(ValueError, match="325632 bytes"):
        tc._tile_plan(spatial, 144, 144, c, heads, 2, True, fused=True)
