"""Host time of cutting the windows (slice, pad, stack in numpy), a scene:
the self time of the program's span ``predict.cut`` per
``predict.scene`` span."""

from portbench.metrics.program_spans import self_ms_per_unit

LAYER = "predict: predict.py ScenePredictor"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "host_clock", "predict_windows_per_s"
WORKLOADS = ["predict-transformer-scene"]


def read(ctx):
    return self_ms_per_unit(["predict.cut"], "predict.scene")
