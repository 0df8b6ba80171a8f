"""Public orchestration API: ``fit`` and ``load_model`` (port of the part
of cultionet_tpu/model.py that trains and restores; ``fit_transfer`` and
``predict`` over chip datasets are not ported yet)."""

import typing as T
from pathlib import Path

from .config import CultionetParams
from .models import CultioNet
from .train.checkpoint import Checkpointer
from .train.fit import FitResult, model_from_kwargs
from .train.fit import fit as _fit
from .train.optim import build_optimizer
from .train.step import TrainState, create_train_state
from .utils.device import resolve_device

# Checkpoint hyperparams that are not model arguments.
_NON_MODEL_KEYS = (
    "in_channels",
    "edge_class",
    "loss_name",
    "log_transform",
    "normalized_input",
)


def fit(params: CultionetParams, device="cuda") -> FitResult:
    """Train a model (``train/fit.py::fit``) on ``device``."""
    return _fit(params, device=device)


def load_model(
    ckpt_dir: T.Union[str, Path], which: str = "best", device="cuda"
) -> T.Tuple[TrainState, CultioNet]:
    """Rebuild the model from the hyperparams a checkpoint carries and
    restore its parameters and BatchNorm statistics on ``device`` (no
    optimizer state); ``which`` falls back from ``best`` to ``last``.
    The model goes to ``predict.py::ScenePredictor`` as it is."""
    device = resolve_device(device)
    if not Path(ckpt_dir).is_dir():
        raise FileNotFoundError(f"No checkpoint under {ckpt_dir}")
    ckpt = Checkpointer(Path(ckpt_dir))
    if not (ckpt.has_best() or ckpt.has_last()):
        raise FileNotFoundError(f"No checkpoint under {ckpt_dir}")
    if which == "best" and not ckpt.has_best():
        which = "last"
    hp = dict(ckpt.load_meta(which)["hyperparams"])
    in_channels = hp.get("in_channels", 3)
    for key in _NON_MODEL_KEYS:
        hp.pop(key, None)
    model = model_from_kwargs(in_channels, hp)
    template = create_train_state(
        model, build_optimizer("AdamW", 1e-3), device=device
    )
    state = ckpt.restore(template, which, with_opt_state=False)
    return state, state.model.eval()
