"""The model's FLOPs a second (roofline.py's count of the cell's work)
over the window, as a share of the card's bf16 dense peak."""

from portbench.metrics.readers import mfu_percent

LAYER = "model step: models/ forward and backward"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "host_clock", "predict_windows_per_s"
WORKLOADS = ["predict-transformer-scene"]


def read(ctx):
    return mfu_percent(ctx)
