"""Host time inside each train-step call, a step."""

from portbench.metrics.readers import host_ms_per_unit

LAYER = "train step: train/step.py make_train_step, make_hbm_train_step"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "host_clock", "train_chips_per_s"
WORKLOADS = ["train-conv-hbm"]


def read(ctx):
    return host_ms_per_unit(ctx, "step_host")
