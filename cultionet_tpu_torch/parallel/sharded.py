"""Data-parallel train, eval and predict steps (port of
cultionet_tpu/parallel/sharded.py).

JAX jits its single-device steps with the batch sharded over the mesh, and
GSPMD makes the gradients and the BatchNorm statistics global. Here each
rank runs the single-device step of ``train/step.py`` on its own block of
the global batch (``mesh.py::shard_batch``) inside
``mesh.py::data_parallel``: BatchNorm sums its statistics over the group,
the loss and the metrics are taken over the gathered outputs, and one
all-reduce of the flat gradient, divided by the world size, runs between
the backward and the optimizer (the psum JAX inserts). N ranks with the
global batch split N ways so compute the single-process step at the whole
batch; the clip and the accumulation of ``k`` mini-steps see the global
gradient. Each rank's dropout draws from its own generator (``fit`` seeds
it with ``random_seed + rank``).

``train/step.py`` is imported where a step is built: the steps' modules
import this package (``mesh.py``).
"""

import typing as T

import torch
from torch import nn

from .mesh import data_parallel, gather_blocks, rank_and_world, reduce_gradients


def make_sharded_train_step(**train_kwargs):
    """``make_train_step(**train_kwargs)`` over the default process group:
    ``step(state, local_batch, generator)`` takes this rank's block of the
    global batch and returns the global batch's logs."""
    from ..train.step import make_train_step

    inner = make_train_step(reduce_gradients=reduce_gradients, **train_kwargs)

    def step(state, batch, generator):
        with data_parallel():
            return inner(state, batch, generator)

    return step


def make_sharded_eval_step(**eval_kwargs):
    """``make_eval_step(**eval_kwargs)`` over the default process group:
    ``step(state, local_batch)`` returns the metrics of the global
    batch."""
    from ..train.step import make_eval_step

    inner = make_eval_step(**eval_kwargs)

    def step(state, batch):
        with data_parallel():
            return inner(state, batch)

    return step


def make_sharded_predict_step(
    model: nn.Module, precision: str = "fp32", device="cuda"
) -> T.Callable:
    """``make_predict_step``'s step on this rank's block of windows, whose
    outputs are gathered into the global batch's on every rank: the
    counterpart of JAX's name for code that already runs in a process
    group (torchrun). The port's own multi-card predict,
    ``predict.py::ScenePredictor(devices=N)``, needs no group: it runs a
    replica per card from one process."""
    from ..train.step import make_predict_step

    inner = make_predict_step(model, precision=precision, device=device)
    world = rank_and_world()[1]

    def step(x, lat=None, lon=None) -> T.Dict[str, T.Optional[torch.Tensor]]:
        outputs = inner(x, lat, lon)
        if world == 1:
            return outputs
        return {
            name: None if value is None else gather_blocks(value)
            for name, value in outputs.items()
        }

    return step
