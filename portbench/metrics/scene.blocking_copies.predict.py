"""Copies between host and card made with ``non_blocking=False``, each a
wait of the host for the stream, a scene: the program's counter
``blocking_copies`` over the ``predict.scene`` spans, per span."""

from portbench.metrics.program_spans import count_per_unit

LAYER = "predict: predict.py ScenePredictor"
UNIT, BETTER, SOURCE, MOVES = "copies", "lower", "program_counter", "predict_windows_per_s"
WORKLOADS = ["predict-transformer-scene"]


def read(ctx):
    return count_per_unit("blocking_copies", "predict.scene")
