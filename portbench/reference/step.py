"""The reference train step, its input pipelines, the optimizer and the
scene blend, in fp32: the same math as the CLI-default ``fit`` loop,
written out plainly.

- ``host_chip``: a chip as ``ChipDataset`` delivers it (int16 x 10000
  scaled and clipped to [1e-9, 1], a host augmenter drawn with
  probability ``augment_prob`` from the dataset's numpy generator, the
  z-score).
- ``device_batch``: a resident batch as the step prepares it
  (dequantize, clip, a dihedral transform per sample drawn from the
  step's generator, the z-score).
- ``ReferenceTrainer``: the model in training mode, the multi-task
  Tanimoto-complement loss, the global-norm clip and AdamW with the
  OneCycle learning rate and beta1 cycle, one update a step.
- ``taper_weights`` and ``blend``: the scene's windows stitched by their
  raised-cosine weights.
"""

import contextlib
import math
import typing as T

import numpy as np
import torch

from .augmenters import Augmenters
from .batch import Batch
from .dropout import dropout_rng
from .enums import InferenceNames, ValidationNames
from .labels import get_true_labels
from .losses import TanimotoComplementLoss

Tensor = torch.Tensor

SCALE_FACTOR = 10000.0
AUGMENTATIONS = (
    "tswarp", "tsnoise", "tsdrift", "tspeaks", "rot90", "rot180", "rot270",
    "roll", "fliplr", "flipud", "gaussian", "saltpepper", "cropresize",
    "perlin",
)


def dequantize(x: Tensor) -> Tensor:
    if x.is_floating_point():
        return x
    return x.to(torch.float32) * torch.tensor(
        1.0 / SCALE_FACTOR, dtype=torch.float32, device=x.device
    )


def host_chip(
    x: np.ndarray,
    y: np.ndarray,
    bdist: np.ndarray,
    rng: np.random.Generator,
    augment_prob: float,
    norm: T.Tuple[np.ndarray, np.ndarray],
) -> T.Tuple[Tensor, Tensor, Tensor]:
    """One (T, H, W, C) int16 chip with its (H, W) labels and int16
    distances, as the host loader delivers it: (1, T, H, W, C) fp32 x, y
    and bdist on the host."""
    xs = np.clip(x.astype(np.float32) / SCALE_FACTOR, 1e-9, 1.0)
    bs = np.clip(bdist.astype(np.float32) / SCALE_FACTOR, 1e-9, 1.0)
    batch = Batch(
        x=torch.from_numpy(xs[None]),
        y=torch.from_numpy(np.asarray(y)[None]),
        bdist=torch.from_numpy(bs[None]),
    )
    if augment_prob > 0 and rng.random() > (1.0 - augment_prob):
        name = str(rng.choice(list(AUGMENTATIONS)))
        batch = Augmenters([name], rng=rng)(batch)
    mean = torch.as_tensor(np.asarray(norm[0], np.float32))
    std = torch.as_tensor(np.asarray(norm[1], np.float32))
    return (batch.x - mean) / std, batch.y, batch.bdist


def dihedral_maps(size: int, device) -> Tensor:
    """(8, size * size): the source pixel of each output pixel for code
    ``k + 4 * flip`` (flip W first, then rot90 k times)."""
    grid = torch.arange(size * size, device=device).reshape(size, size)
    maps = []
    for flip in (False, True):
        for k in range(4):
            image = torch.flip(grid, dims=(1,)) if flip else grid
            maps.append(torch.rot90(image, k=k, dims=(0, 1)).reshape(-1))
    return torch.stack(maps)


def device_batch(
    x: Tensor,
    y: Tensor,
    bdist: Tensor,
    generator: torch.Generator,
    norm: T.Tuple[Tensor, Tensor],
    dihedral: bool,
) -> T.Tuple[Tensor, Tensor, Tensor]:
    """Resident int16 rows as the device-data step prepares them."""
    x = dequantize(x).clamp(1e-9, 1.0)
    bdist = dequantize(bdist).clamp(1e-9, 1.0)
    y = y.to(torch.int32)
    if dihedral:
        num, steps, height, width, channels = x.shape
        codes = torch.randint(
            0, 8, (num,), generator=generator, device=generator.device
        )
        src = dihedral_maps(height, x.device)[codes.to(x.device)]
        x = x.reshape(num, steps, height * width, channels).gather(
            2, src[:, None, :, None].expand(num, steps, height * width, channels)
        ).reshape(num, steps, height, width, channels)
        y = y.reshape(num, -1).gather(1, src).reshape(num, height, width)
        bdist = bdist.reshape(num, -1).gather(1, src).reshape(
            num, height, width
        )
    return (x - norm[0]) / norm[1], y, bdist


def calc_loss(
    outputs: T.Mapping[str, Tensor], y: Tensor, bdist: Tensor, edge_class: int
) -> Tensor:
    """(distance + edge + crop) / 3 of the Tanimoto-complement losses."""
    cls_loss = TanimotoComplementLoss()
    reg_loss = TanimotoComplementLoss(transform_logits=False, one_hot_targets=False)
    true = get_true_labels(y, edge_class=edge_class)
    mask = true[ValidationNames.MASK]
    dist_loss = reg_loss(outputs[InferenceNames.DISTANCE], bdist, mask=mask)
    edge_loss = cls_loss(
        outputs[InferenceNames.EDGE], true[ValidationNames.TRUE_EDGE], mask=mask
    )
    crop_loss = cls_loss(
        outputs[InferenceNames.CROP], true[ValidationNames.TRUE_CROP], mask=mask
    )
    return (dist_loss + edge_loss + crop_loss) / 3.0


def onecycle_lr(step: int, total: int, peak: float) -> float:
    """Cosine one-cycle: peak / 25 up to the peak at 30% of ``total``,
    then down to peak / 2.5e5 at ``total``."""
    total = max(total, 10)
    bounds = (0, int(0.3 * total), total)
    values = (peak / 25.0, peak, peak / 25.0 / 1e4)
    for i in range(2):
        if bounds[i] <= step < bounds[i + 1]:
            pct = (step - bounds[i]) / (bounds[i + 1] - bounds[i])
            start, end = values[i], values[i + 1]
            return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)
    return values[-1] if step >= bounds[-1] else 0.0


def onecycle_beta1(step: int, total: int) -> float:
    """AdamW's beta1 from 0.95 down to 0.85 over the warm-up, back to 0.95
    by the end."""
    total = max(total, 10)
    warm = int(total * 0.3)
    step = min(step, total)
    if step < warm:
        return 0.95 + (0.85 - 0.95) * (step / max(warm, 1))
    frac = (step - warm) / max(total - warm, 1)
    return 0.85 + (0.95 - 0.85) * 0.5 * (1 - math.cos(math.pi * frac))


class ReferenceTrainer:
    """The fp32 model and AdamW (beta2 0.98, decoupled weight decay) after
    a global-norm clip; ``step`` takes one prepared batch. ``compute``
    (``compute(model)`` gives a context) wraps the forward and the
    backward alone: the clip and AdamW act on the fp32 parameters after
    it has closed."""

    def __init__(self, model: torch.nn.Module, train: T.Mapping[str, T.Any],
                 total_steps: int,
                 compute: T.Optional[T.Callable[[torch.nn.Module], T.ContextManager]] = None):
        self.model = model
        self.compute = compute or (lambda model: contextlib.nullcontext())
        self.train = dict(train)
        self.total = total_steps
        self.count = 0
        self.params = dict(model.named_parameters())
        self.m = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.first_grads: T.Optional[T.Dict[str, Tensor]] = None

    def step(self, x: Tensor, y: Tensor, bdist: Tensor,
             generator: torch.Generator) -> float:
        self.model.train()
        for p in self.params.values():
            p.grad = None
        with self.compute(self.model):
            with dropout_rng(generator):
                outputs = self.model(x)
            outputs = {
                k: v.float() for k, v in outputs.items() if v is not None
            }
            loss = calc_loss(outputs, y, bdist, self.train["edge_class"])
            loss.backward()
        with torch.no_grad():
            grads = {
                n: (torch.zeros_like(p) if p.grad is None else p.grad)
                for n, p in self.params.items()
            }
            norm = torch.sqrt(sum(g.double().pow(2).sum() for g in grads.values()))
            limit = self.train["gradient_clip_val"]
            scale = 1.0 if float(norm) < limit else limit / float(norm)
            grads = {n: g * scale for n, g in grads.items()}
            if self.first_grads is None:
                self.first_grads = {n: g.clone() for n, g in grads.items()}
            self._adamw(grads)
        return float(loss.detach())

    def _adamw(self, grads: T.Mapping[str, Tensor]) -> None:
        lr = onecycle_lr(self.count, self.total, self.train["learning_rate"])
        b1 = onecycle_beta1(self.count, self.total)
        b2, eps = 0.98, self.train["eps"]
        wd = self.train["weight_decay"]
        self.count += 1
        t = self.count
        for n, p in self.params.items():
            g = grads[n]
            p.mul_(1.0 - lr * wd)
            self.m[n].lerp_(g, 1.0 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = self.v[n].sqrt() / math.sqrt(1.0 - b2**t) + eps
            p.addcdiv_(self.m[n], denom, value=-lr / (1.0 - b1**t))


def taper_weights(window_size: int, padding: int, device) -> Tensor:
    """(S, S): 1 inside, a raised-cosine ramp over the padding, >= 1e-4."""
    steps = torch.arange(1, padding + 1, dtype=torch.float32, device=device)
    ramp = 0.5 - 0.5 * torch.cos(math.pi * (steps / (padding + 1)))
    profile = torch.cat([ramp, torch.ones(window_size, device=device), ramp.flip(0)])
    return torch.clamp(torch.outer(profile, profile), min=1e-4)
