"""Train, eval and predict steps (port of cultionet_tpu/train/step.py).

The JAX steps are pure functions compiled by XLA; here they run eagerly
and update the state in place:

- ``create_train_state``: the fp32 model (master weights and BatchNorm
  running statistics) on the device, bound to its optimizer.
- ``make_train_step``: ``step(state, batch, generator) -> (state, logs)``.
  The in-step input pipeline (dequantize; with ``norm_stats`` clip to
  [1e-9, 1]; dihedral and noise augmentation; z-score), then the forward
  in the compute type (bf16 copies of the fp32 parameters under
  "16-mixed"), multi-task loss in fp32, backward into fp32 gradients, one
  optimizer step; the augmentation and every dropout draw from
  ``generator``.
- ``make_hbm_train_step``: the same step over a device-resident split
  (``data/device_cache.py``), from a (B,) index vector.
- ``make_eval_step``: the loss, the metric suite and the composite score
  (for class logits under ``CrossEntropyLoss``, U-TAE's objective, or
  ``MaskedCrossEntropyLoss``, TSViT's: the loss and the confusion matrix,
  whose overall accuracy and mean IoU ``fit`` reports over the validation
  split).
- ``make_predict_step``: the model's outputs for a batch of windows.
"""

import copy
import dataclasses
import typing as T

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..augment.device import augment_batch_on_device
from ..data.batch import Batch, dequantize
from ..data.device_cache import gather_batch
from ..enums import InferenceNames, LossTypes, ValidationNames
from ..nn.dropout import dropout_rng
from ..nn.init import init_parameters_
from ..parallel.mesh import gather_for_loss, plain_named_parameters
from ..utils.device import resolve_device
from ..utils.profiling import span, to_device
from .graphed import GraphedStep
from .labels import get_true_labels
from .loss_registry import CLASS_LOSSES, LOSS_DICT
from ..losses import class_targets
from .metrics import (
    confusion_counts,
    fbeta_score,
    mae,
    matthews_corrcoef,
    mse,
    probas_to_labels,
)
from .optim import Optimizer, OptimizerSpec
from .precision import cast_floating, resolve_dtype

Tensor = torch.Tensor
Outputs = T.Dict[str, T.Optional[Tensor]]


@dataclasses.dataclass
class TrainState:
    """The fp32 model, its optimizer and the number of steps taken."""

    model: nn.Module
    optimizer: Optimizer
    step: int = 0


def create_train_state(
    model: nn.Module,
    tx: OptimizerSpec,
    seed: T.Optional[int] = None,
    device="cuda",
) -> TrainState:
    """Move ``model`` to ``device`` in fp32 and bind ``tx`` to its
    parameters. With ``seed`` the parameters are first drawn anew
    (``nn/init.py``); without it the model keeps its weights (for example
    ones translated from the JAX package by ``utils/params.py``)."""
    device = resolve_device(device)
    if seed is not None:
        init_parameters_(model, torch.Generator().manual_seed(seed))
    model = model.to(device=device, dtype=torch.float32)
    return TrainState(model=model, optimizer=tx.init(model.parameters()))


def class_weights_from_counts(
    crop_counts, edge_counts
) -> T.Dict[str, np.ndarray]:
    """(bg, fg) class weights from dataset pixel counts: w_c = n / (k n_c),
    zero where a class is absent; more than two crop counts collapse to
    background and foreground."""

    def calc(counts):
        counts = np.asarray(counts, dtype=np.float64)
        if counts.size > 2:
            counts = np.array([counts[0], counts[1:].sum()])
        total = counts.sum()
        with np.errstate(divide="ignore", invalid="ignore"):
            w = total / (len(counts) * counts)
        return np.nan_to_num(w, nan=0.0, posinf=0.0, neginf=0.0).astype(
            np.float32
        )

    return {"crop": calc(crop_counts), "edge": calc(edge_counts)}


def calc_loss(
    predictions: Outputs,
    batch: Batch,
    loss_name: str = LossTypes.TANIMOTO_COMBINED,
    edge_class: int = 2,
    class_weights: T.Optional[T.Dict[str, T.Any]] = None,
) -> T.Tuple[Tensor, T.Dict[str, Tensor]]:
    """Multi-task loss: distance + edge + crop, equally weighted; under a
    class loss (``CLASS_LOSSES``) the class-logit objective alone: the
    ``crop_type`` logits against ``y``, the void class weighing 0
    (``losses.CrossEntropyLoss``) or left out (``MaskedCrossEntropyLoss``).

    ``class_weights`` (from ``class_weights_from_counts``) weights the
    classification pixels by class: the set losses multiply inputs and
    targets by the mask, so the mask ``mask * sqrt(w)`` gives the exactly
    weighted sums.
    """
    losses = LOSS_DICT[loss_name]
    if loss_name in CLASS_LOSSES:
        return losses["classification"](predictions[InferenceNames.CROP_TYPE], batch.y), {}
    combined = LOSS_DICT[LossTypes.TANIMOTO_COMBINED]
    reg_loss = losses.get("regression") or combined["regression"]
    cls_loss = losses.get("classification") or combined["classification"]

    true = get_true_labels(batch.y, edge_class=edge_class)
    mask = true[ValidationNames.MASK]
    edge_true = true[ValidationNames.TRUE_EDGE]
    crop_true = true[ValidationNames.TRUE_CROP]

    edge_mask = crop_mask = mask
    if class_weights is not None:

        def weighted(labels: Tensor, weights) -> Tensor:
            w = torch.as_tensor(weights, dtype=torch.float32, device=labels.device)
            return mask * torch.sqrt(torch.where(labels == 1, w[1], w[0]))

        edge_mask = weighted(edge_true, class_weights["edge"])
        crop_mask = weighted(crop_true, class_weights["crop"])

    dist_loss = reg_loss(
        predictions[InferenceNames.DISTANCE], batch.bdist, mask=mask
    )
    edge_loss = cls_loss(
        predictions[InferenceNames.EDGE], edge_true, mask=edge_mask
    )
    crop_loss = cls_loss(
        predictions[InferenceNames.CROP], crop_true, mask=crop_mask
    )
    loss = (dist_loss + edge_loss + crop_loss) / 3.0
    return loss, {"dloss": dist_loss, "eloss": edge_loss, "closs": crop_loss}


def _check_generator(generator: torch.Generator, device: torch.device):
    if not isinstance(generator, torch.Generator):
        raise TypeError("the train step takes a torch.Generator")
    if generator.device.type != device.type:
        raise ValueError(
            f"the step runs on {device}; its generator lies on "
            f"{generator.device}"
        )


def model_inputs(
    batch: Batch, compute_dtype: torch.dtype
) -> T.Tuple[T.Optional[Tensor], ...]:
    """The model's positional inputs from a batch: ``x`` in the compute
    type and the chips' ``lat`` and ``lon`` as they are (the JAX steps
    cast only ``x``); a batch with acquisition dates adds ``dates`` and
    ``date_count`` (U-TAE's)."""
    inputs = (batch.x.to(compute_dtype), batch.lat, batch.lon)
    if batch.dates is None:
        return inputs
    return inputs + (batch.dates, batch.date_count)


def forward_loss(
    model: nn.Module,
    batch: Batch,
    generator: torch.Generator,
    compute_dtype: torch.dtype = torch.float32,
    **loss_kwargs,
) -> T.Tuple[Tensor, T.Dict[str, Tensor]]:
    """The differentiated half of the train step (the JAX step's
    ``loss_fn``): ``model`` in training mode on bf16 (or fp32) copies of its
    parameters, dropout drawn from ``generator``, outputs cast to fp32 and
    the loss of ``calc_loss(**loss_kwargs)``. ``batch`` lies on the model's
    device; ``loss.backward()`` leaves fp32 gradients in the parameters
    (outside ``dropout_rng``: a rematerialized segment replays its own
    generator, ``nn/remat.py``). Inside ``parallel/mesh.py::data_parallel``
    the loss is the global batch's (``gather_for_loss``); FSDP casts the
    parameters it shards itself."""
    batch = batch.dequantize()
    model.train()
    run_params = cast_floating(plain_named_parameters(model), compute_dtype)
    with dropout_rng(generator):
        outputs = functional_call(
            model, run_params, model_inputs(batch, compute_dtype)
        )
    outputs, batch = gather_for_loss(
        cast_floating(outputs, torch.float32), batch
    )
    return calc_loss(outputs, batch, **loss_kwargs)


def clip_unit(batch: Batch) -> Batch:
    """x and bdist clipped to [1e-9, 1], as ``ChipDataset`` clips the
    chips of the host path: raw chips of the device data path then see its
    range."""
    return batch.replace(
        x=batch.x.clamp(1e-9, 1.0),
        bdist=None if batch.bdist is None else batch.bdist.clamp(1e-9, 1.0),
    )


def zscore(batch: Batch, norm: T.Tuple[Tensor, Tensor]) -> Batch:
    """x z-scored with the fp32 per-channel ``norm`` (mean, std)."""
    return batch.replace(x=(batch.x - norm[0]) / norm[1])


def norm_tensors(
    norm_stats: T.Optional[T.Tuple[T.Any, T.Any]], device: torch.device
) -> T.Optional[T.Tuple[Tensor, Tensor]]:
    """``norm_stats`` (per-channel mean, std) as fp32 tensors on
    ``device``."""
    if norm_stats is None:
        return None
    return tuple(
        torch.as_tensor(np.asarray(v), dtype=torch.float32, device=device)
        for v in norm_stats
    )


def make_train_step(
    loss_name: str = LossTypes.TANIMOTO_COMBINED,
    edge_class: int = 2,
    precision: str = "fp32",
    class_weights: T.Optional[T.Dict[str, T.Any]] = None,
    device_augment: bool = False,
    device_augment_noise: float = 0.0,
    norm_stats: T.Optional[T.Tuple[T.Any, T.Any]] = None,
    device="cuda",
    reduce_gradients: T.Optional[T.Callable[[nn.Module], None]] = None,
) -> T.Callable[
    [TrainState, Batch, torch.Generator],
    T.Tuple[TrainState, T.Dict[str, Tensor]],
]:
    """Build a train step ``(state, batch, generator) -> (state, logs)``
    on ``device``; the state is updated in place and returned.

    The batch (int16 x 10000 records or floats) is dequantized on the
    device. With ``norm_stats`` = (mean, std) per channel, x and bdist are
    first clipped to [1e-9, 1], and x is z-scored after the augmentation.
    ``device_augment`` draws a dihedral transform per sample and
    ``device_augment_noise`` > 0 adds Gaussian noise of that std to x
    (``augment/device.py``), both from ``generator`` before the forward.

    With ``precision="bf16"`` (or "16-mixed") the forward and backward run
    in bf16 on bf16 copies of the fp32 parameters; gradients land in fp32
    and the optimizer updates the fp32 weights. BatchNorm running
    statistics stay fp32 (``nn/blocks.py::BatchNorm``). The logs hold
    0-d tensors on the device (reading them waits for the step).
    ``reduce_gradients(model)`` runs between the backward and the optimizer
    (the data-parallel all-reduce, ``parallel/sharded.py``); the step
    carries it as ``step.reduce_gradients``.
    """
    device = resolve_device(device)
    compute_dtype = resolve_dtype(precision)
    norm = norm_tensors(norm_stats, device)
    if class_weights is not None:  # on the device once, not copied each step
        class_weights = {
            name: torch.as_tensor(np.asarray(w), dtype=torch.float32, device=device)
            for name, w in class_weights.items()
        }
    augment = device_augment or device_augment_noise > 0

    def train_step(
        state: TrainState, batch: Batch, generator: torch.Generator
    ) -> T.Tuple[TrainState, T.Dict[str, Tensor]]:
        with span("train.step", join=True):
            _check_generator(generator, device)
            with span("train.prepare"):
                batch = batch.to(device).dequantize()
                if norm is not None:
                    batch = clip_unit(batch)
                if augment:
                    batch = augment_batch_on_device(
                        batch,
                        generator,
                        dihedral=device_augment,
                        noise_sigma=device_augment_noise,
                    )
                if norm is not None:
                    batch = zscore(batch, norm)
            with span("train.forward"):
                loss, report = forward_loss(
                    state.model,
                    batch,
                    generator,
                    compute_dtype,
                    loss_name=loss_name,
                    edge_class=edge_class,
                    class_weights=class_weights,
                )
            with span("train.backward"):
                loss.backward()
            if reduce_gradients is not None:
                with span("train.reduce"):
                    reduce_gradients(state.model)
            with span("train.optimizer"):
                state.optimizer.step()
            state.step += 1
            logs = {"loss": loss, **report}
            return state, {name: value.detach() for name, value in logs.items()}

    train_step.reduce_gradients = reduce_gradients
    return train_step


def make_hbm_train_step(
    inner: T.Optional[T.Callable] = None,
    **train_kwargs,
) -> T.Callable[
    [TrainState, T.Mapping[str, T.Optional[Tensor]], Tensor, torch.Generator],
    T.Tuple[TrainState, T.Dict[str, Tensor]],
]:
    """A train step over a device-resident split:
    ``step(state, arrays, indices, generator)`` gathers the (B,) chip rows
    ``indices`` from the resident int16 ``arrays``
    (``data/device_cache.py``) on the device, then runs the train step
    ``inner`` on them (by default ``make_train_step(**train_kwargs)``; the
    sharded step under data parallelism). The index vector is all that a
    step needs from the host. Where the step can see that it is safe
    (``train/graphed.py::eager_reason``), it is captured as one CUDA graph
    on its third call and replayed from then on."""
    if inner is None:
        inner = make_train_step(**train_kwargs)
    device = resolve_device(train_kwargs.get("device", "cuda"))

    def eager(state, arrays, indices, generator):
        with span("train.gather"):
            batch = gather_batch(arrays, to_device(indices, device))
        return inner(state, batch, generator)

    graphed = GraphedStep(eager, inner)

    def step(state, arrays, indices, generator):
        with span("train.step"):
            return graphed(state, arrays, indices, generator)

    return step


def evaluate_predictions(
    predictions: Outputs,
    batch: Batch,
    loss_name: str = LossTypes.TANIMOTO_COMBINED,
    edge_class: int = 2,
    class_weights: T.Optional[T.Dict[str, T.Any]] = None,
) -> T.Dict[str, Tensor]:
    """Loss, metric suite and composite score ``score``; under a class
    loss (``CLASS_LOSSES``) the loss and ``confusion``, the confusion
    matrix of the predicted classes (rows the true class) whose last row
    and column are void's: (K, K) under ``CrossEntropyLoss``, whose last
    logit is void, (K + 1, K + 1) under ``MaskedCrossEntropyLoss``, void's
    pixels in the added row."""
    if loss_name in CLASS_LOSSES:
        logits = predictions[InferenceNames.CROP_TYPE]
        k = logits.shape[-1]
        loss, _ = calc_loss(predictions, batch, loss_name=loss_name)
        classes = k if loss_name == LossTypes.CROSS_ENTROPY else k + 1
        confusion = confusion_counts(
            logits.argmax(-1), class_targets(batch.y, classes, -1),
            num_classes=classes,
        )
        return {"loss": loss, "confusion": confusion}
    loss, report = calc_loss(
        predictions,
        batch,
        loss_name=loss_name,
        edge_class=edge_class,
        class_weights=class_weights,
    )
    true = get_true_labels(batch.y, edge_class=edge_class)
    mask = true[ValidationNames.MASK]
    edge_true = true[ValidationNames.TRUE_EDGE]
    crop_true = true[ValidationNames.TRUE_CROP]

    dist_pred = predictions[InferenceNames.DISTANCE][..., 0]
    dist_mae = mae(dist_pred, batch.bdist, mask=mask)
    dist_mse = mse(dist_pred, batch.bdist, mask=mask)

    edge_ypred = probas_to_labels(predictions[InferenceNames.EDGE])
    crop_ypred = probas_to_labels(predictions[InferenceNames.CROP])
    edge_fscore = fbeta_score(edge_ypred, edge_true, beta=2.0, mask=mask)
    crop_fscore = fbeta_score(crop_ypred, crop_true, beta=2.0, mask=mask)
    edge_mcc = matthews_corrcoef(edge_ypred, edge_true, mask=mask)
    crop_mcc = matthews_corrcoef(crop_ypred, crop_true, mask=mask)

    total_score = (
        loss
        + (1.0 - edge_fscore)
        + (1.0 - crop_fscore)
        + dist_mae
        + (1.0 - edge_mcc.clamp_min(0.0))
        + (1.0 - crop_mcc.clamp_min(0.0))
    )
    return {
        "loss": loss,
        "dist_mae": dist_mae,
        "dist_mse": dist_mse,
        "edge_f1": edge_fscore,
        "crop_f1": crop_fscore,
        "edge_mcc": edge_mcc,
        "crop_mcc": crop_mcc,
        "score": total_score,
        **report,
    }


def make_eval_step(
    loss_name: str = LossTypes.TANIMOTO_COMBINED,
    edge_class: int = 2,
    precision: str = "fp32",
    class_weights: T.Optional[T.Dict[str, T.Any]] = None,
    device="cuda",
) -> T.Callable[[TrainState, Batch], T.Dict[str, Tensor]]:
    """Build an eval step ``(state, batch) -> metrics`` on ``device``: the
    model in eval mode, its parameters and running statistics cast to the
    compute type, outputs scored in fp32 (over the global batch inside
    ``parallel/mesh.py::data_parallel``)."""
    device = resolve_device(device)
    compute_dtype = resolve_dtype(precision)

    def eval_step(state: TrainState, batch: Batch) -> T.Dict[str, Tensor]:
        batch = batch.to(device).dequantize()
        model = state.model.eval()
        tensors = plain_named_parameters(model)
        tensors.update(model.named_buffers())
        with torch.no_grad():
            outputs = functional_call(
                model,
                cast_floating(tensors, compute_dtype),
                model_inputs(batch, compute_dtype),
            )
            outputs, batch = gather_for_loss(
                cast_floating(outputs, torch.float32), batch
            )
            return evaluate_predictions(
                outputs,
                batch,
                loss_name=loss_name,
                edge_class=edge_class,
                class_weights=class_weights,
            )

    return eval_step


def _inference_apply(
    model: nn.Module,
    x: Tensor,
    compute_dtype: torch.dtype,
    lat: T.Optional[Tensor] = None,
    lon: T.Optional[Tensor] = None,
) -> T.Dict[str, T.Optional[Tensor]]:
    """Dequantize, run ``model`` (already in ``compute_dtype``) on ``x`` in
    the compute dtype and the coordinates as they are, and return fp32
    outputs."""
    outputs = model(dequantize(x).to(compute_dtype), lat, lon)
    return {
        name: None if value is None else value.float()
        for name, value in outputs.items()
    }


def make_predict_step(
    model: nn.Module, precision: str = "fp32", device="cuda"
) -> T.Callable[[Tensor], T.Dict[str, T.Optional[Tensor]]]:
    """A predict step bound to an eval copy of ``model`` whose parameters
    and buffers are cast to the compute dtype once, on ``device`` (JAX casts
    them inside every step; the weights do not change while predicting).
    The step takes ``x`` (B, T, H, W, C), int16-packed or float, and the
    chips' (B,) ``lat`` and ``lon`` (used by a ``use_latlon`` model), moves
    them to the device and runs under ``torch.inference_mode``."""
    device = resolve_device(device)
    compute_dtype = resolve_dtype(precision)
    run_model = copy.deepcopy(model).to(device=device, dtype=compute_dtype)
    run_model.eval()

    def on_device(value):
        return None if value is None else to_device(torch.as_tensor(value), device)

    def predict_step(
        x: Tensor, lat: T.Optional[Tensor] = None, lon: T.Optional[Tensor] = None
    ) -> T.Dict[str, T.Optional[Tensor]]:
        with torch.inference_mode():
            with span("predict.copy"):
                x, lat, lon = on_device(x), on_device(lat), on_device(lon)
            with span("predict.forward"):
                return _inference_apply(run_model, x, compute_dtype, lat, lon)

    return predict_step
