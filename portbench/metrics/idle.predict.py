"""The card's idle share over the profiled spans of the window."""

from portbench.metrics.readers import idle_percent

LAYER = "device"
UNIT, BETTER, SOURCE, MOVES = "%", "lower", "device_trace", "predict_windows_per_s"
WORKLOADS = ["predict-transformer-scene"]


def read(ctx):
    return idle_percent(ctx)
