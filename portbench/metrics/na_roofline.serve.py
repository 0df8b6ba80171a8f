"""Neighborhood attention's share of its roofline in the eval forward, through the registered op cultionet_tpu_torch::na2d:
the least time of the counted na2d_fwd launches at the decoder's NA
sites over their device time."""

from portbench.metrics.readers import roofline_percent

LAYER = "kernels: ops/csrc/na2d_fwd.cu, na2d_bwd.cu, temporal_fwd.cu"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "device_trace", "serve_p95_ms"
WORKLOADS = ["serve-conv-b8"]
PATTERNS = ["na2d_fwd_kernel"]


def read(ctx):
    c = ctx.counts
    if c is None or not c.na_sites:
        return None
    return roofline_percent(
        ctx, PATTERNS, c.na_least_seconds(2, False), ["na2d_fwd"], len(c.na_sites)
    )
