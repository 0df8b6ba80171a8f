"""Rematerialization of a segment of the model (port of flax ``nn.remat``
over the TowerUNet's encoder, decoder and fusion,
cultionet_tpu/models/tower_unet.py).

``checkpoint(module, *args)`` runs ``module(*args)`` under
``torch.utils.checkpoint`` (non-reentrant): the segment keeps only its
inputs, and the backward pass runs it a second time to recover what it
needs. flax replays the same dropout rng in that second run; here three
things would break it, and the segment's recompute context repairs each:

- dropout and the NA kernels' seeds draw from the generator that
  ``nn/dropout.py::dropout_rng`` puts in scope, but the backward runs
  outside that block (and, on CUDA, in autograd's own thread, where the
  context variable is unset). The generator and its state are captured
  at the segment's entry; the recompute runs under that generator, set to
  that state, and the generator's state from before the recompute is put
  back after it, so the step leaves the generator where the plain step
  does.
- the train step runs the model on compute-type copies of its parameters
  (``torch.func.functional_call``), which are swapped out again before
  the backward. The tensors the segment ran on are captured and swapped
  in for the recompute.
- BatchNorm updates its running statistics in every training forward.
  ``recomputing()`` is true inside a recompute, and ``nn/blocks.py::
  BatchNorm`` skips the update there, so it happens once a step, as under
  flax's remat.
"""

import contextlib
import contextvars
import typing as T

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint as torch_checkpoint

from ..parallel.mesh import plain_named_parameters
from .dropout import _GENERATOR

_RECOMPUTING: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "recomputing", default=False
)


def recomputing() -> bool:
    """True while a checkpointed segment is being recomputed."""
    return _RECOMPUTING.get()


@contextlib.contextmanager
def _replay(generator: T.Optional[torch.Generator], state):
    token = _RECOMPUTING.set(True)
    generator_token = None
    if generator is not None:
        generator_token = _GENERATOR.set(generator)
        after = generator.get_state()
        generator.set_state(state)
    try:
        yield
    finally:
        if generator is not None:
            generator.set_state(after)
            _GENERATOR.reset(generator_token)
        _RECOMPUTING.reset(token)


def _run(module: nn.Module, tensors: T.Dict[str, torch.Tensor], *args):
    if recomputing():
        return functional_call(module, tensors, args)
    return module(*args)


def checkpoint(module: nn.Module, *args):
    """``module(*args)``, rematerialized in the backward pass."""
    generator = _GENERATOR.get()
    state = None if generator is None else generator.get_state()
    tensors = {
        **plain_named_parameters(module),
        **dict(module.named_buffers()),
    }
    return torch_checkpoint(
        _run,
        module,
        tensors,
        *args,
        use_reentrant=False,
        preserve_rng_state=False,
        context_fn=lambda: (contextlib.nullcontext(), _replay(generator, state)),
    )
