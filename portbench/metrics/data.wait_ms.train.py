"""Host time inside the train loader's ``next()`` a step."""

from portbench.metrics.readers import host_ms_per_unit

LAYER = "data: data/loader.py ChipLoader, data/device_cache.py, augment/"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "host_clock", "train_chips_per_s"
WORKLOADS = ["train-conv-hbm"]


def read(ctx):
    return host_ms_per_unit(ctx, "data_wait")
