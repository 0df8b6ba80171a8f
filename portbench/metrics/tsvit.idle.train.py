"""The card's idle share over the profiled spans of the TSViT window."""

from portbench.metrics.readers import idle_percent

LAYER = "device"
UNIT, BETTER, SOURCE, MOVES = "%", "lower", "device_trace", "train_chips_per_s"
WORKLOADS = ["train-tsvit-pastis24"]


def read(ctx):
    return idle_percent(ctx)
