"""Copies between host and card made with ``non_blocking=False``, each a
wait of the host for the stream, a call: the program's counter
``blocking_copies`` over the ``serve.call`` spans, per span."""

from portbench.metrics.program_spans import count_per_unit

LAYER = "serve: export.py ExportedPredictor"
UNIT, BETTER, SOURCE, MOVES = "copies", "lower", "program_counter", "serve_p95_ms"
WORKLOADS = ["serve-conv-b8"]


def read(ctx):
    return count_per_unit("blocking_copies", "serve.call")
