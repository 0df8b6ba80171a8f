from .distributed import (
    assert_same_across_hosts,
    initialize_distributed,
    topology_summary,
)
from .mesh import (
    data_parallel,
    fsdp_state_sharding,
    global_batch_from_local,
    rank_and_world,
    replicate_state,
    shard_batch,
    shard_state_fsdp,
)
from .sharded import (
    make_sharded_eval_step,
    make_sharded_predict_step,
    make_sharded_train_step,
)

__all__ = [
    "assert_same_across_hosts",
    "data_parallel",
    "fsdp_state_sharding",
    "global_batch_from_local",
    "initialize_distributed",
    "make_sharded_eval_step",
    "make_sharded_predict_step",
    "make_sharded_train_step",
    "rank_and_world",
    "replicate_state",
    "shard_batch",
    "shard_state_fsdp",
    "topology_summary",
]
