"""Launches of the temporal attention kernels a TSViT train step: the
program's counters ``temporal_fwd`` and ``temporal_bwd`` (``ops/
temporal_cuda.py::LAUNCHES``, which a graph replay moves as the eager step
does) over the ``train.step`` spans; a forward and a backward for each
temporal layer. Nothing where the program records no such span."""

from portbench.metrics.program_spans import count_per_unit

LAYER = "kernels: ops/csrc/na2d_fwd.cu, na2d_bwd.cu, temporal_fwd.cu"
UNIT, BETTER, SOURCE, MOVES = "launches", "lower", "program_counter", "train_chips_per_s"
WORKLOADS = ["train-tsvit-pastis24"]


def read(ctx):
    fwd = count_per_unit("temporal_fwd", "train.step")
    bwd = count_per_unit("temporal_bwd", "train.step")
    if fwd is None or bwd is None:
        return None
    return fwd + bwd
