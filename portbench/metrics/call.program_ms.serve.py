"""Host time of the exported program's call, a call: the self time of the
program's span ``serve.program`` per ``serve.call`` span."""

from portbench.metrics.program_spans import self_ms_per_unit

LAYER = "serve: export.py ExportedPredictor"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "host_clock", "serve_p95_ms"
WORKLOADS = ["serve-conv-b8"]


def read(ctx):
    return self_ms_per_unit(["serve.program"], "serve.call")
