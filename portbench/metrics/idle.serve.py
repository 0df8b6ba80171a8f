"""The card's idle share over the profiled spans of the window."""

from portbench.metrics.readers import idle_percent

LAYER = "device"
UNIT, BETTER, SOURCE, MOVES = "%", "lower", "device_trace", "serve_p95_ms"
WORKLOADS = ["serve-conv-b8"]


def read(ctx):
    return idle_percent(ctx)
