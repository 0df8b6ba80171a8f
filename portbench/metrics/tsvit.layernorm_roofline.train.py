"""The LayerNorms' share of their byte bound in the TSViT step: the least
time of a step's LayerNorms (rows x width read and written once forward;
x and the output gradient read and the input gradient written once
backward, in bf16), times the steps whose backward the program's counter
``layer_norm_rows_bwd`` counted in the ``train.step`` spans (one a
LayerNorm), over the device time of the LayerNorm kernels (the port's and
any of PyTorch's). Nothing where the program has no such counter."""

import typing as T

from portbench.roofline import HBM_BYTES_PER_S

LAYER = "model: models/tsvit.py TSViT"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "device_trace", "train_chips_per_s"
WORKLOADS = ["train-tsvit-pastis24"]
PATTERNS = ["layer_norm", "LayerNorm", "GammaBeta"]
COUNTER, ROOT = "layer_norm_rows_bwd", "train.step"
ITEMSIZE = 2  # the cell's "16-mixed": bf16 copies of the parameters


def layernorm_rows(model: T.Mapping[str, T.Any], sequences: int, tokens: int
                   ) -> T.List[T.Tuple[int, int]]:
    """(rows, LayerNorms) of a TSViT step whose temporal encoder runs over
    ``sequences`` (B N) sequences of ``tokens`` (K + T): two a layer and
    the closing one in the temporal encoder; in the spatial encoder, over
    B K sequences of N patches, two a layer, its closing one and the
    head's."""
    k = int(model["num_classes"])
    return [
        (sequences * tokens, 2 * int(model["temporal_depth"]) + 1),
        (sequences * k, 2 * int(model["spatial_depth"]) + 2),
    ]


def step_least_seconds(model: T.Mapping[str, T.Any], sequences: int, tokens: int) -> float:
    """The least time of a step's LayerNorms: 2 + 3 tensors of rows x width
    moved once each."""
    width = int(model["dim"])
    moved = sum(rows * n for rows, n in layernorm_rows(model, sequences, tokens))
    return 5 * moved * width * ITEMSIZE / HBM_BYTES_PER_S


def steps_counted(model: T.Mapping[str, T.Any]) -> T.Optional[float]:
    """Steps' worth of backward launches in the profiled ``train.step``
    spans, or None where the program counts none."""
    from cultionet_tpu_torch.utils import profiling

    totals = getattr(profiling, "totals", None)
    root = totals().get(ROOT) if totals is not None else None
    if not root or not root.get("count") or COUNTER not in root["counts"]:
        return None
    per_step = sum(n for _, n in layernorm_rows(model, 1, 1))
    return root["counts"][COUNTER] / per_step


def read(ctx):
    c = ctx.counts
    if c is None or not getattr(c, "temporal_sites", None):
        return None
    model = ctx.config["model"]
    steps = steps_counted(model)
    seconds = ctx.tracer.device_seconds(PATTERNS)
    if not steps or seconds <= 0:
        return None
    sequences, tokens = c.temporal_sites[0][:2]
    return 100.0 * steps * step_least_seconds(model, sequences, tokens) / seconds
