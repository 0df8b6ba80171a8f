"""Operations of a TSViT train step and its temporal attention sites,
from its shapes.

``count_tsvit`` runs the reference TSViT (``reference/tsvit.py``) forward
and backward on the meta device under ``torch.utils.flop_counter``: its
matrix products, the attention's einsums among them, at every token the
model computes (the K class tokens and every date, pads included, as the
published model computes them). LayerNorms, GELUs, softmaxes and adds are
elementwise and not counted, as ``roofline.py`` counts no elementwise
work. The temporal attention sites are the temporal encoder's layers, one
(B N, K + T, K + T, d, heads, B N) site each, whose least time
``roofline.py::temporal_bytes_ops`` gives for the kernels ``temporal_fwd``
and ``temporal_bwd``.
"""

import dataclasses
import typing as T

import torch

from .roofline import TemporalSite, least_seconds, temporal_bytes_ops

# The model's keyword arguments that the reference TSViT takes.
REFERENCE_KEYS = (
    "img_res", "patch_size", "num_classes", "dim", "temporal_depth", "spatial_depth",
    "heads", "dim_head", "scale_dim",
)


@dataclasses.dataclass
class TsvitCounts:
    """One train step of a cell: its FLOPs and its temporal sites."""

    step_flops: float
    temporal_sites: T.List[TemporalSite]

    def flops(self) -> float:
        return self.step_flops

    def temporal_least_seconds(self, itemsize: int, backward: bool) -> float:
        return sum(
            least_seconds(*temporal_bytes_ops(s, itemsize, backward), itemsize)
            for s in self.temporal_sites
        )


def reference_tsvit(model_kwargs: T.Mapping[str, T.Any]):
    """The reference TSViT of a configuration's ``model`` section."""
    from .reference.tsvit import TSViT

    kwargs = {k: model_kwargs[k] for k in REFERENCE_KEYS if k in model_kwargs}
    return TSViT(in_channels=int(model_kwargs["in_channels"]), **kwargs)


def count_tsvit(model_kwargs: T.Mapping[str, T.Any], batch: int, steps: int) -> TsvitCounts:
    """A train step of ``batch`` tiles of ``steps`` dates (pads included)."""
    from torch.utils.flop_counter import FlopCounterMode

    size = int(model_kwargs["img_res"])
    with torch.device("meta"):
        model = reference_tsvit(model_kwargs)
        x = torch.empty(batch, steps, size, size, int(model_kwargs["in_channels"]))
        doy = torch.zeros(batch, steps, dtype=torch.int64)
    counter = FlopCounterMode(display=False)
    with counter:
        model(x, doy).sum().backward()
    n = batch * (size // int(model_kwargs["patch_size"])) ** 2
    s = int(model_kwargs["num_classes"]) + steps
    c = int(model_kwargs["heads"]) * int(model_kwargs["dim_head"])
    sites = [(n, s, s, c, int(model_kwargs["heads"]), n)] * int(model_kwargs["temporal_depth"])
    return TsvitCounts(step_flops=float(counter.get_total_flops()), temporal_sites=sites)
