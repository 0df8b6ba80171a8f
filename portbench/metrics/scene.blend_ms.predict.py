"""Host time of the blend of each batch into the scene's buffers, a scene:
the self time of the program's span ``predict.blend`` per
``predict.scene`` span."""

from portbench.metrics.program_spans import self_ms_per_unit

LAYER = "predict: predict.py ScenePredictor"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "host_clock", "predict_windows_per_s"
WORKLOADS = ["predict-transformer-scene"]


def read(ctx):
    return self_ms_per_unit(["predict.blend"], "predict.scene")
