"""Learning-rate range finder (port of cultionet_tpu/train/lr_finder.py;
Smith 2015, Lightning's ``Tuner.lr_find``).

``auto_lr_find`` runs an exponential sweep of the learning rate instead of
training: the real train step with the configured model, optimizer and
loss, the learning rate rising from ``MIN_LR`` to ``MAX_LR`` over
``num_steps`` updates. The loss is smoothed by a bias-corrected EMA
(``EMA_BETA``); the sweep stops when the loss is not finite or the
smoothed loss exceeds ``DIVERGE_FACTOR`` times its best; the suggestion
is the learning rate at the steepest descent of the smoothed curve
(Lightning's ``lr_finder.suggestion()`` rule).
"""

import dataclasses
import logging
import typing as T

import numpy as np
import torch

from ..config import CultionetParams
from ..data.loader import ChipLoader
from ..utils.device import resolve_device
from .optim import build_optimizer
from .step import create_train_state, make_train_step

logger = logging.getLogger(__name__)

MIN_LR = 1e-7
MAX_LR = 1.0
EMA_BETA = 0.9
DIVERGE_FACTOR = 4.0


@dataclasses.dataclass
class LRFindResult:
    lrs: T.List[float]
    losses: T.List[float]  # EMA-smoothed
    raw_losses: T.List[float]
    suggestion: T.Optional[float]


def suggest_lr(
    lrs: T.Sequence[float], smoothed: T.Sequence[float], skip: int = 5
) -> T.Optional[float]:
    """The learning rate at the steepest negative slope of the smoothed
    loss curve, ignoring the first ``skip`` warm-in points; None when the
    sweep is too short."""
    if len(lrs) <= skip + 2:
        return None
    gradients = np.gradient(np.asarray(smoothed[skip:]))
    return float(np.asarray(lrs[skip:])[int(np.argmin(gradients))])


def lr_find(
    params: CultionetParams,
    num_steps: int = 100,
    device="cuda",
) -> LRFindResult:
    """Exponential learning-rate sweep over the whole dataset (shuffled,
    in the JAX loader's order) on ``device``; the model is built and
    initialized from ``params`` as ``fit`` builds it."""
    from .fit import build_model

    device = resolve_device(device)
    dataset = params.dataset
    if params.in_channels is None:
        params.update_channels(dataset)

    loader = ChipLoader(
        dataset, batch_size=params.batch_size, shuffle=True, device=device
    )
    # The JAX sweep draws its first batch to initialize the model, which
    # draws one shuffle; draw it too, so the sweep sees the same batches.
    loader.skip_epochs(1)

    def schedule(step: int) -> float:
        frac = min(step / max(num_steps - 1, 1), 1.0)
        return MIN_LR * (MAX_LR / MIN_LR) ** frac

    tx = build_optimizer(
        optimizer=params.optimizer,
        learning_rate=schedule,
        weight_decay=params.weight_decay,
        eps=params.eps,
        gradient_clip_val=params.gradient_clip_val,
    )
    state = create_train_state(
        build_model(params), tx, seed=params.random_seed, device=device
    )
    train_step = make_train_step(
        loss_name=params.loss_name,
        edge_class=params.edge_class,
        precision=params.compute_precision,
        device=device,
    )
    generator = torch.Generator(device=device).manual_seed(params.random_seed)

    lrs: T.List[float] = []
    raw: T.List[float] = []
    smoothed: T.List[float] = []
    ema = 0.0
    best = float("inf")
    step_idx = 0
    while step_idx < num_steps:
        for batch in loader:
            if step_idx >= num_steps:
                break
            state, logs = train_step(state, batch, generator)
            loss = float(logs["loss"])
            lr = schedule(step_idx)
            ema = EMA_BETA * ema + (1.0 - EMA_BETA) * loss
            corrected = ema / (1.0 - EMA_BETA ** (step_idx + 1))
            lrs.append(lr)
            raw.append(loss)
            smoothed.append(corrected)
            best = min(best, corrected)
            step_idx += 1
            if not np.isfinite(loss) or corrected > DIVERGE_FACTOR * best:
                step_idx = num_steps  # diverged: stop the sweep
                break

    suggestion = suggest_lr(lrs, smoothed)
    if suggestion is not None:
        logger.info(f"The suggested learning rate is {suggestion:.3e}")
    else:
        logger.warning("LR sweep too short for a suggestion")
    return LRFindResult(
        lrs=lrs, losses=smoothed, raw_losses=raw, suggestion=suggestion
    )
