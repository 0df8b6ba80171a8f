"""PyTorch's GroupNorm's share of its byte bound in the U-TAE step: every
GroupNorm of a step at its padded shapes (the encoder's eleven, L-TAE's
two), input read and output written once in the forward, input, output
gradient and input gradient once in the backward
(``roofline_utae.py``), times the steps in the profiled spans, over the
device time of the GroupNorm kernels (statistics, fused parameters, the
normalizing pass and the backward's)."""

LAYER = "model: models/utae.py UTAE"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "device_trace", "train_chips_per_s"
WORKLOADS = ["train-utae-pastis"]
PATTERNS = [
    "GroupNorm", "RowwiseMoments", "ComputeFusedParams", "ComputeInternalGradients",
    "ComputeBackwardFusedParams", "GammaBetaBackward", "Compute1dBackwardFusedParams",
]


def read(ctx):
    c, t = ctx.counts, ctx.tracer
    if c is None or not t.iterations:
        return None
    seconds = t.device_seconds(PATTERNS)
    if seconds <= 0:
        return None
    return 100.0 * t.iterations * c.groupnorm_least_seconds(2) / seconds
