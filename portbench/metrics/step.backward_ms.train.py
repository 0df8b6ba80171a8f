"""Host time of the backward, a step: the self time of the program's span
``train.backward`` per ``train.step`` span."""

from portbench.metrics.program_spans import self_ms_per_unit

LAYER = "train step: train/step.py make_train_step, make_hbm_train_step"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "host_clock", "train_chips_per_s"
WORKLOADS = ["train-conv-hbm"]


def read(ctx):
    return self_ms_per_unit(["train.backward"], "train.step")
