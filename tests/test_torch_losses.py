"""The port's losses, labels, metrics and multi-task loss
(cultionet_tpu_torch/losses, train/labels.py, train/metrics.py,
train/step.py::calc_loss and evaluate_predictions) against the JAX package,
fp32 on the CPU: the same numpy inputs through both, to 1e-6 absolute and
relative (sums of a few hundred fp32 terms in another order; the
class-weighted losses reach a few units), and the reference's golden
values."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cultionet_tpu import losses as jax_losses
from cultionet_tpu.data.batch import Batch as JaxBatch
from cultionet_tpu.train import labels as jax_labels
from cultionet_tpu.train import metrics as jax_metrics
from cultionet_tpu.train import step as jax_step
from cultionet_tpu.train.loss_registry import LOSS_DICT as JAX_LOSS_DICT
from cultionet_tpu_torch import losses as torch_losses
from cultionet_tpu_torch.data.batch import Batch
from cultionet_tpu_torch.train import labels as torch_labels
from cultionet_tpu_torch.train import metrics as torch_metrics
from cultionet_tpu_torch.train import step as torch_step
from cultionet_tpu_torch.train.loss_registry import LOSS_DICT

ATOL = 1e-6
B, H, W = 2, 20, 20


def _both(fn_jax, fn_torch, *arrays, **kwargs):
    want = fn_jax(*(None if a is None else jnp.asarray(a) for a in arrays), **kwargs)
    got = fn_torch(
        *(None if a is None else torch.from_numpy(np.asarray(a)) for a in arrays),
        **kwargs,
    )
    return np.asarray(got), np.asarray(want)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    return {
        "prob": rng.random((B, H, W, 1)).astype("float32"),
        "prob2": rng.dirichlet((0.5, 0.5), size=(B, H, W)).astype("float32"),
        "logit2": rng.uniform(-3, 3, (B, H, W, 2)).astype("float32"),
        "labels": rng.integers(0, 2, (B, H, W)).astype("int32"),
        "dist": rng.random((B, H, W)).astype("float32"),
        "mask": rng.integers(0, 2, (B, H, W)).astype("int32"),
        "y": rng.integers(-1, 3, (B, H, W)).astype("int32"),
    }


@pytest.mark.parametrize(
    "name,role",
    [(name, role) for name in JAX_LOSS_DICT for role in JAX_LOSS_DICT[name]],
)
@pytest.mark.parametrize("masked", [False, True])
def test_registry_loss_matches_jax(data, name, role, masked):
    assert set(LOSS_DICT[name]) == set(JAX_LOSS_DICT[name])
    if role == "classification":
        inputs, targets = data["prob"], data["labels"]
    else:
        inputs, targets = data["prob"], data["dist"]
    mask = data["mask"] if masked else None
    got, want = _both(
        lambda i, t, m: JAX_LOSS_DICT[name][role](i, t, mask=m),
        lambda i, t, m: LOSS_DICT[name][role](i, t, mask=m),
        inputs,
        targets,
        mask,
    )
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("transform_logits", [False, True])
def test_preprocess_and_multiclass_losses_match_jax(data, transform_logits):
    inputs = data["logit2"] if transform_logits else data["prob2"]
    kwargs = dict(transform_logits=transform_logits)
    for fn in ("preprocess",):
        got, want = (
            [np.asarray(t) for t in pair]
            for pair in (
                getattr(torch_losses, fn)(
                    torch.from_numpy(inputs),
                    torch.from_numpy(data["labels"]),
                    torch.from_numpy(data["mask"]),
                    **kwargs,
                ),
                getattr(jax_losses, fn)(
                    jnp.asarray(inputs),
                    jnp.asarray(data["labels"]),
                    jnp.asarray(data["mask"]),
                    **kwargs,
                ),
            )
        )
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, atol=ATOL)
    for fn in ("tanimoto_dist_loss", "tanimoto_complement_loss", "tversky_loss"):
        got, want = _both(
            getattr(jax_losses, fn),
            getattr(torch_losses, fn),
            inputs,
            data["labels"],
            data["mask"],
            **kwargs,
        )
        np.testing.assert_allclose(got, want, atol=ATOL, err_msg=fn)


@pytest.mark.parametrize("masked", [False, True])
def test_cl_dice_and_skeleton_match_jax(data, masked):
    mask = data["mask"] if masked else None
    got, want = _both(
        jax_losses.cl_dice_loss,
        torch_losses.cl_dice_loss,
        data["logit2"],
        data["labels"][..., None].astype("float32"),
        mask,
    )
    np.testing.assert_allclose(got, want, atol=ATOL)
    got, want = _both(
        lambda x: jax_losses.soft_skeleton(x, num_iter=5),
        lambda x: torch_losses.soft_skeleton(x, num_iter=5),
        data["prob2"],
    )
    np.testing.assert_allclose(got, want, atol=ATOL)
    loss = torch_losses.CLDiceLoss()(
        torch.from_numpy(data["logit2"]),
        torch.from_numpy(data["labels"][..., None].astype("float32")),
    )
    assert torch.isfinite(loss)


@pytest.fixture(scope="module")
def golden_inputs():
    """tests/test_losses.py's draws (the reference's test_loss.py order),
    channel-last."""
    rng = np.random.default_rng(100)
    rng.uniform(low=-3, high=3, size=(B, 2, H, W))
    crop_prob = (
        rng.dirichlet((0.5, 0.5), size=(B * H * W))
        .astype("float32")
        .reshape(B, H, W, 2)
    )
    rng.random((B, 1, H, W))
    dist = rng.random((B, 1, H, W)).astype("float32")
    targets = rng.integers(low=0, high=2, size=(B, H, W))
    rng.integers(low=0, high=1, size=(B, H, W))
    dist_targets = rng.random((B, H, W)).astype("float32")
    mask = rng.integers(low=0, high=2, size=(B, 1, H, W))
    return {
        "crop_prob": torch.from_numpy(crop_prob),
        "dist": torch.from_numpy(dist.transpose(0, 2, 3, 1).copy()),
        "targets": torch.from_numpy(targets),
        "dist_targets": torch.from_numpy(dist_targets),
        "mask": torch.from_numpy(mask[:, 0].copy()),
    }


def test_golden_values(golden_inputs):
    g = golden_inputs
    cases = [
        (torch_losses.TanimotoDistLoss(), (0.611, 0.431)),
        (torch_losses.TanimotoComplementLoss(), (0.824, 0.692)),
        (
            torch_losses.CombinedLoss(
                [
                    torch_losses.TanimotoDistLoss(),
                    torch_losses.TanimotoComplementLoss(),
                ]
            ),
            (0.717, 0.561),
        ),
    ]
    for loss_fn, (plain, masked) in cases:
        assert round(float(loss_fn(g["crop_prob"], g["targets"])), 3) == plain
        value = loss_fn(g["crop_prob"], g["targets"], mask=g["mask"])
        assert round(float(value), 3) == masked
    regression = [
        (torch_losses.TanimotoDistLoss(one_hot_targets=False), 0.417),
        (torch_losses.TanimotoComplementLoss(one_hot_targets=False), 0.704),
    ]
    for loss_fn, value in regression:
        assert round(float(loss_fn(g["dist"], g["dist_targets"])), 3) == value


def test_true_labels_match_jax(data):
    want = jax_labels.get_true_labels(jnp.asarray(data["y"]), edge_class=2)
    got = torch_labels.get_true_labels(torch.from_numpy(data["y"]), edge_class=2)
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == torch.int32
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))


@pytest.mark.parametrize("masked", [False, True])
def test_metrics_match_jax(data, masked):
    rng = np.random.default_rng(9)
    pred_labels = rng.integers(0, 2, (B, H, W)).astype("int32")
    mask = data["mask"] if masked else None
    for fn, args in (
        ("mae", (data["prob"][..., 0], data["dist"])),
        ("mse", (data["prob"][..., 0], data["dist"])),
        ("confusion_counts", (pred_labels, data["labels"])),
        ("fbeta_score", (pred_labels, data["labels"])),
        ("matthews_corrcoef", (pred_labels, data["labels"])),
        ("dice_score", (pred_labels, data["labels"])),
        ("jaccard_score", (pred_labels, data["labels"])),
    ):
        got, want = _both(
            lambda p, t, m: getattr(jax_metrics, fn)(p, t, mask=m),
            lambda p, t, m: getattr(torch_metrics, fn)(p, t, mask=m),
            *args,
            mask,
        )
        np.testing.assert_allclose(got, want, atol=ATOL, err_msg=fn)
    for probs in (data["prob"], data["prob2"]):
        got, want = _both(
            jax_metrics.probas_to_labels, torch_metrics.probas_to_labels, probs
        )
        np.testing.assert_array_equal(got, want)
    # A class absent from predictions and targets leaves the macro mean.
    ones = np.ones((B, H, W), "int32")
    got, want = _both(
        jax_metrics.fbeta_score, torch_metrics.fbeta_score, ones, ones
    )
    np.testing.assert_allclose(got, want, atol=ATOL)


def _predictions(seed):
    rng = np.random.default_rng(seed)
    return {
        name: rng.random((B, H, W, 1)).astype("float32")
        for name in ("distance", "edge", "crop")
    }


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize(
    "loss_name", ["TanimotoComplementLoss", "TanimotoCombined", "TverskyLoss"]
)
def test_calc_loss_and_metrics_match_jax(data, weighted, loss_name):
    preds = _predictions(11)
    weights = (
        torch_step.class_weights_from_counts([900, 100], [990, 10])
        if weighted
        else None
    )
    want = jax_step.evaluate_predictions(
        {k: jnp.asarray(v) for k, v in preds.items()},
        JaxBatch(
            x=jnp.zeros((B, 1, H, W, 1)),
            y=jnp.asarray(data["y"]),
            bdist=jnp.asarray(data["dist"]),
        ),
        loss_name=loss_name,
        class_weights=weights,
    )
    got = torch_step.evaluate_predictions(
        {k: torch.from_numpy(v) for k, v in preds.items()},
        Batch(
            x=torch.zeros(B, 1, H, W, 1),
            y=torch.from_numpy(data["y"]),
            bdist=torch.from_numpy(data["dist"]),
        ),
        loss_name=loss_name,
        class_weights=weights,
    )
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(
            got[name].numpy(),
            np.asarray(want[name]),
            atol=ATOL,
            rtol=ATOL,
            err_msg=name,
        )


def test_class_weights_match_jax():
    for crop, edge in (([900, 100], [990, 10]), ([100, 0], [0, 5])):
        got = torch_step.class_weights_from_counts(crop, edge)
        want = jax_step.class_weights_from_counts(crop, edge)
        for name in ("crop", "edge"):
            np.testing.assert_array_equal(got[name], want[name])


def test_batch_dequantize_matches_jax(data):
    rng = np.random.default_rng(2)
    x = rng.integers(0, 10000, (B, 3, H, W, 2)).astype("int16")
    bdist = rng.integers(0, 10000, (B, H, W)).astype("int16")
    y = data["y"].astype("int16")
    want = JaxBatch(
        x=jnp.asarray(x), y=jnp.asarray(y), bdist=jnp.asarray(bdist)
    ).dequantize()
    got = Batch(
        x=torch.from_numpy(x), y=torch.from_numpy(y), bdist=torch.from_numpy(bdist)
    ).dequantize()
    for name in ("x", "y", "bdist"):
        value = getattr(got, name)
        np.testing.assert_array_equal(
            value.numpy(), np.asarray(getattr(want, name))
        )
    assert got.y.dtype == torch.int32 and got.x.dtype == torch.float32
