"""Neighborhood attention's share of its roofline in the train step:
the least time of the counted launches of the dropout kernels (forward
and backward, at the decoder's NA sites) over their device time."""

from portbench.metrics.readers import roofline_percent

LAYER = "kernels: ops/csrc/na2d_fwd.cu, na2d_bwd.cu, temporal_fwd.cu"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "device_trace", "train_chips_per_s"
WORKLOADS = ["train-conv-hbm"]
PATTERNS = ["na2d_fwd_kernel", "na2d_bwd_"]


def read(ctx):
    c = ctx.counts
    if c is None or not c.na_sites:
        return None
    # One forward and one backward launch a site; itemsize 2 (bf16).
    cycle = c.na_least_seconds(2, False) + c.na_least_seconds(2, True)
    return roofline_percent(
        ctx, PATTERNS, cycle, ["na2d_fwd_drop", "na2d_bwd_drop"], 2 * len(c.na_sites)
    )
