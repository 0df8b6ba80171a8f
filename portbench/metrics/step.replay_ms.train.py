"""Host time of the train step's CUDA graph replays
(``train/graphed.py``), a step: the self time of the program's span
``train.replay`` per ``train.step`` span, 0 where every step ran
eagerly. Nothing where the program has no graph counters (no replay
span either)."""

from portbench.metrics.program_spans import self_ms_per_unit

LAYER = "train step: train/step.py make_train_step, make_hbm_train_step"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "program_span", "train_chips_per_s"
WORKLOADS = ["train-conv-hbm"]


def read(ctx):
    from cultionet_tpu_torch.utils import profiling

    if "graph_replays" not in getattr(profiling, "COUNTS", {}):
        return None
    return self_ms_per_unit(["train.replay"], "train.step")
