"""The U-TAE step's FLOPs a second over the window, as a share of the
card's bf16 dense peak: ``roofline_utae.py``'s count, the real date
images alone (the padding the program computes is not counted)."""

from portbench.metrics.readers import mfu_percent

LAYER = "model step: models/ forward and backward"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "host_clock", "train_chips_per_s"
WORKLOADS = ["train-utae-pastis"]


def read(ctx):
    return mfu_percent(ctx)
