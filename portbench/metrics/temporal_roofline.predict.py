"""Temporal attention's share of its roofline in the transformer's eval
forward: the least time of the counted temporal_fwd launches (two layer
calls and the pooling a forward) over their device time."""

from portbench.metrics.readers import roofline_percent

LAYER = "kernels: ops/csrc/na2d_fwd.cu, na2d_bwd.cu, temporal_fwd.cu"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "device_trace", "predict_windows_per_s"
WORKLOADS = ["predict-transformer-scene"]
PATTERNS = ["temporal_fwd_kernel"]


def read(ctx):
    c = ctx.counts
    if c is None or not c.temporal_sites:
        return None
    return roofline_percent(
        ctx, PATTERNS, c.temporal_least_seconds(2, False), ["temporal_fwd"],
        len(c.temporal_sites),
    )
