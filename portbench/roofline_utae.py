"""Operations and GroupNorm bytes of a U-TAE train step, from its shapes.

``count_utae`` runs the reference U-TAE (``reference/utae.py``) forward
and backward on the meta device under ``torch.utils.flop_counter`` at one
and at two dates, every date real: the convolutions' and matrix products'
FLOPs are linear in the dates (the encoder runs once a date image, L-TAE's
projections and attention once a date a pixel; the decoder once a chip),
so the two give the FLOPs a date image adds and those a step has besides.
Only real dates count: a step's FLOPs are the fixed part plus the
per-image part times the step's real date images, so the padding the
program computes is left out of ``mfu``. The attention-weighted sums over
time and the resizes are elementwise and not counted, as ``roofline.py``
counts no elementwise work.

GroupNorm's least time: each GroupNorm call of the step at its padded
shapes (every date the program normalizes, pads included: the kernels'
work), its input read once and its output written once in the forward,
input, output gradient and input gradient once each in the backward, over
the card's HBM bandwidth.
"""

import dataclasses
import math
import typing as T

import torch

from .roofline import HBM_BYTES_PER_S

# The model's keyword arguments that the reference U-TAE takes.
REFERENCE_KEYS = (
    "encoder_widths", "decoder_widths", "out_conv", "str_conv_k", "str_conv_s",
    "str_conv_p", "encoder_norm", "n_head", "d_model", "d_k", "padding_mode",
)


@dataclasses.dataclass
class UtaeCounts:
    """One train step of a cell: ``fixed_flops`` plus ``image_flops`` for
    each of ``real_images`` (the mean real date images a step), and the
    GroupNorm shapes of one step at the padded dates."""

    fixed_flops: float
    image_flops: float
    real_images: float
    groupnorm_shapes: T.List[T.Tuple[int, ...]]

    def flops(self) -> float:
        return self.fixed_flops + self.image_flops * self.real_images

    def groupnorm_bytes(self, itemsize: int) -> float:
        return sum(5 * math.prod(s) * itemsize for s in self.groupnorm_shapes)

    def groupnorm_least_seconds(self, itemsize: int) -> float:
        return self.groupnorm_bytes(itemsize) / HBM_BYTES_PER_S


def reference_utae(model_kwargs: T.Mapping[str, T.Any]):
    """The reference U-TAE of a configuration's ``model`` section."""
    from .reference.utae import UTAE

    kwargs = {k: model_kwargs[k] for k in REFERENCE_KEYS if k in model_kwargs}
    return UTAE(input_dim=int(model_kwargs["in_channels"]), **kwargs)


def _step_on_meta(model_kwargs, batch: int, steps: int, size: int, hook=None) -> float:
    """FLOPs of one forward and backward, every date real, on meta."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        # Eval mode: no dropout draw; the same convolutions and products.
        model = reference_utae(model_kwargs).eval()
        x = torch.empty(batch, steps, int(model_kwargs["in_channels"]), size, size)
        days = torch.empty(batch, steps)
    hooks = [] if hook is None else [
        m.register_forward_pre_hook(hook)
        for m in model.modules() if isinstance(m, torch.nn.GroupNorm)
    ]
    counter = FlopCounterMode(display=False)
    try:
        with counter:
            model(x, days, None).sum().backward()
    finally:
        for h in hooks:
            h.remove()
    return float(counter.get_total_flops())


def count_utae(
    model_kwargs: T.Mapping[str, T.Any], batch: int, steps: int, size: int,
    real_images: float,
) -> UtaeCounts:
    """A train step of ``batch`` chips of ``size`` px padded to ``steps``
    dates, ``real_images`` of its date images real (a mean is fine)."""
    shapes: T.List[T.Tuple[int, ...]] = []
    one = _step_on_meta(model_kwargs, batch, 1, size)
    two = _step_on_meta(model_kwargs, batch, 2, size)
    _step_on_meta(model_kwargs, batch, steps, size,
                  hook=lambda module, args: shapes.append(tuple(args[0].shape)))
    per_date = two - one  # one date image of each of the batch's chips
    return UtaeCounts(
        fixed_flops=one - per_date,
        image_flops=per_date / batch,
        real_images=float(real_images),
        groupnorm_shapes=shapes,
    )
