"""How often the train step ran as a CUDA graph replay
(``train/graphed.py``): the program's counter ``graph_replays`` over the
``train.step`` spans, per span (1 where every step replays, 0 where every
step runs eagerly). Nothing where the program has no such counter."""

from portbench.metrics.program_spans import count_per_unit

LAYER = "train step: train/step.py make_train_step, make_hbm_train_step"
UNIT, BETTER, SOURCE, MOVES = "replays", "higher", "program_counter", "train_chips_per_s"
WORKLOADS = ["train-conv-hbm"]


def read(ctx):
    from cultionet_tpu_torch.utils import profiling

    if "graph_replays" not in getattr(profiling, "COUNTS", {}):
        return None
    return count_per_unit("graph_replays", "train.step")
