"""Public orchestration API: ``fit``, ``fit_transfer``, ``load_model`` and
``predict`` over a chip dataset (port of cultionet_tpu/model.py)."""

import typing as T
from pathlib import Path

import numpy as np
import torch

from .config import CultionetParams
from .data.batch import Batch
from .data.loader import ChipLoader
from .models import CultioNet
from .predict import BAND_NAMES
from .train.checkpoint import Checkpointer
from .train.fit import FitResult, model_from_kwargs
from .train.fit import fit as _fit
from .train.optim import build_optimizer
from .train.step import TrainState, create_train_state, make_predict_step
from .utils.device import resolve_device
from .utils.profiling import to_host

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


def fit_transfer(params: CultionetParams, device="cuda") -> FitResult:
    """Transfer learning from a pretrained checkpoint on ``device``.

    ``params.ckpt_file`` names the NEW checkpoint (its own store); the
    pretrained parameters and BatchNorm statistics come from the ``last``
    checkpoint of ``params.pretrained_ckpt`` where set, else of the default
    store ``last_store`` beside ``ckpt_file``. ``params.finetune`` picks
    what trains: 'all' everything; 'fc' only the final heads; None only the
    final heads, re-initialized.
    """
    pretrained_dir = getattr(params, "pretrained_ckpt", None)
    if pretrained_dir is None:
        pretrained_dir = Path(params.ckpt_file).parent / "last_store"
    state, _ = load_model(pretrained_dir, which="last", device=device)
    return _fit(params, pretrained_state=state, device=device)


def _choose_checkpoint(
    ckpt_dir: T.Union[str, Path], which: str
) -> T.Tuple[Checkpointer, str]:
    """The store and the checkpoint in it to read: ``best`` falls back to
    ``last``."""
    if not Path(ckpt_dir).is_dir():
        raise FileNotFoundError(f"No checkpoint under {ckpt_dir}")
    ckpt = Checkpointer(Path(ckpt_dir))
    if not (ckpt.has_best() or ckpt.has_last()):
        raise FileNotFoundError(f"No checkpoint under {ckpt_dir}")
    if which == "best" and not ckpt.has_best():
        which = "last"
    return ckpt, which


def checkpoint_hyperparams(
    ckpt_dir: T.Union[str, Path], which: str = "best"
) -> dict:
    """The hyperparams saved with the checkpoint ``load_model`` restores
    for the same ``which``."""
    ckpt, which = _choose_checkpoint(ckpt_dir, which)
    return dict(ckpt.load_meta(which)["hyperparams"])


def load_model(
    ckpt_dir: T.Union[str, Path], which: str = "best", device="cuda"
) -> T.Tuple[TrainState, CultioNet]:
    """Rebuild the model from the hyperparams a checkpoint carries and
    restore its parameters and BatchNorm statistics on ``device`` (no
    optimizer state); ``which`` falls back from ``best`` to ``last``.
    The model goes to ``predict.py::ScenePredictor`` as it is."""
    device = resolve_device(device)
    ckpt, which = _choose_checkpoint(ckpt_dir, which)
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


def predict(
    model: torch.nn.Module,
    dataset,
    batch_size: int = 4,
    precision: str = "bf16",
    writer: T.Optional[T.Callable[[Batch, dict], None]] = None,
    device="cuda",
) -> T.List[T.Dict[str, np.ndarray]]:
    """Run ``model`` over a (predict) chip dataset in file order on
    ``device`` (fp32 on the CPU, as the JAX package predicts off the TPU).

    Each batch's outputs (distance, edge, crop) come back as host numpy
    arrays. ``writer(batch, outputs)`` is called per batch where given
    (a raster writer, say); otherwise the outputs are returned.
    """
    device = resolve_device(device)
    if device.type != "cuda":
        precision = "fp32"
    predict_step = make_predict_step(model, precision, device)
    loader = ChipLoader(
        dataset, batch_size=batch_size, shuffle=False, device=device
    )
    results = []
    for batch in loader:
        outputs = predict_step(batch.x, batch.lat, batch.lon)
        host = {name: to_host(outputs[name]).numpy() for name in BAND_NAMES}
        if writer is not None:
            writer(batch, host)
        else:
            results.append(host)
    return results


# The reference's API name.
predict_lightning = predict
