"""Temporal attention's share of its roofline in the TSViT step: the least
time of the counted temporal_fwd and temporal_bwd launches (a forward and
a backward for each temporal layer, at (B N, K + T, d)) by
``roofline.py::temporal_bytes_ops``, over the two kernels' device time."""

from portbench.metrics.readers import roofline_percent

LAYER = "kernels: ops/csrc/na2d_fwd.cu, na2d_bwd.cu, temporal_fwd.cu"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "device_trace", "train_chips_per_s"
WORKLOADS = ["train-tsvit-pastis24"]
PATTERNS = ["temporal_fwd_kernel", "temporal_bwd_kernel"]


def read(ctx):
    c = ctx.counts
    if c is None or not getattr(c, "temporal_sites", None):
        return None
    least = c.temporal_least_seconds(2, False) + c.temporal_least_seconds(2, True)
    return roofline_percent(
        ctx, PATTERNS, least, ["temporal_fwd", "temporal_bwd"], 2 * len(c.temporal_sites),
    )
