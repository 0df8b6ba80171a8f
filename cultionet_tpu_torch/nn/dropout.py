"""Dropout drawn from an explicit generator.

The JAX modules draw dropout masks from the ``"dropout"`` rng the train step
passes to ``apply``; here the train step runs the model under
``dropout_rng(generator)``, and every dropout in training mode (the channel
dropout, the attention's projection dropout and its kernel seed) draws from
that generator. Nothing draws from torch's global RNG: a training-mode
dropout with a positive rate and no generator in scope raises.
"""

import contextlib
import contextvars
import typing as T

import torch
from torch import nn

Tensor = torch.Tensor

_GENERATOR: contextvars.ContextVar[T.Optional[torch.Generator]] = (
    contextvars.ContextVar("dropout_generator", default=None)
)


@contextlib.contextmanager
def dropout_rng(generator: torch.Generator) -> T.Iterator[torch.Generator]:
    """Make ``generator`` the source of every dropout draw inside the
    block."""
    token = _GENERATOR.set(generator)
    try:
        yield generator
    finally:
        _GENERATOR.reset(token)


def dropout_generator() -> torch.Generator:
    generator = _GENERATOR.get()
    if generator is None:
        raise RuntimeError(
            "dropout in training mode draws from an explicit generator: run "
            "the model under cultionet_tpu_torch.nn.dropout.dropout_rng"
        )
    return generator


class Dropout(nn.Module):
    """Inverted dropout (flax ``nn.Dropout``): keeps each element with
    probability ``1 - p`` and scales it by ``1 / (1 - p)``. ``broadcast_dims``
    share one draw along those axes; ``(2, 3)`` on NCHW drops whole
    channels (``Dropout2d``, the JAX ``broadcast_dims=(1, 2)`` on NHWC)."""

    def __init__(self, p: float, broadcast_dims: T.Sequence[int] = ()):
        super().__init__()
        self.p = p
        self.broadcast_dims = tuple(broadcast_dims)

    def forward(self, x: Tensor) -> Tensor:
        if not self.training or self.p == 0:
            return x
        generator = dropout_generator()
        shape = [
            1 if dim in self.broadcast_dims else size
            for dim, size in enumerate(x.shape)
        ]
        keep = (
            torch.rand(shape, generator=generator, device=generator.device)
            < 1.0 - self.p
        ).to(x.device)
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))

    def extra_repr(self) -> str:
        return f"p={self.p}, broadcast_dims={self.broadcast_dims}"
