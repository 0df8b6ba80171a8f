"""PyTorch's LayerNorm's share of its byte bound in the transformer's
eval forward: rows x width read and written once for every LayerNorm of
a forward, times the forwards in the spans (counted by the na2d_fwd
launches, three a forward), over the LayerNorm kernels' device time."""

from portbench.metrics.readers import roofline_percent

LAYER = "model: models/temporal.py TemporalTransformer"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "device_trace", "predict_windows_per_s"
WORKLOADS = ["predict-transformer-scene"]
PATTERNS = ["layer_norm", "LayerNorm"]


def read(ctx):
    c = ctx.counts
    if c is None or not c.layernorm_shapes or not c.na_sites:
        return None
    return roofline_percent(
        ctx, PATTERNS, c.layernorm_least_seconds(2), ["na2d_fwd"], len(c.na_sites)
    )
