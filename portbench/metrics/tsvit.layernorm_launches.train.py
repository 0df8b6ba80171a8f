"""Launches of the LayerNorm training kernels a TSViT train step: the
program's counters ``layer_norm_rows_train`` (the forward with
statistics) and ``layer_norm_rows_bwd`` (the backward) over the
``train.step`` spans; one of each a LayerNorm, 19 a step. Nothing where
the program records no such span or has no such counter."""

from portbench.metrics.program_spans import count_per_unit

LAYER = "model: models/tsvit.py TSViT"
UNIT, BETTER, SOURCE, MOVES = "launches", "lower", "program_counter", "train_chips_per_s"
WORKLOADS = ["train-tsvit-pastis24"]
COUNTERS = ("layer_norm_rows_train", "layer_norm_rows_bwd")


def read(ctx):
    from cultionet_tpu_torch.ops import flags

    tables = getattr(flags, "launch_tables", None)
    known = {name for table in tables() for name in table} if tables else set()
    if not known.issuperset(COUNTERS):
        return None
    counts = [count_per_unit(name, "train.step") for name in COUNTERS]
    if None in counts:
        return None
    return sum(counts)
