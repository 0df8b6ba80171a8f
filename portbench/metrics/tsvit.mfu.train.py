"""The TSViT step's FLOPs a second over the window, as a share of the
card's bf16 dense peak: ``roofline_tsvit.py``'s count, every token the
model computes, the class tokens and the pad dates included."""

from portbench.metrics.readers import mfu_percent

LAYER = "model step: models/ forward and backward"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "host_clock", "train_chips_per_s"
WORKLOADS = ["train-tsvit-pastis24"]


def read(ctx):
    return mfu_percent(ctx)
