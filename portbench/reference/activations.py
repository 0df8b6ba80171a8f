"""Activation registry (port of cultionet_tpu/nn/activations.py)."""

import typing as T

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

_ACTIVATIONS: T.Dict[str, T.Callable[[Tensor], Tensor]] = {
    "SiLU": F.silu,
    "ReLU": F.relu,
    # jax.nn.gelu defaults to the tanh approximation.
    "GELU": lambda x: F.gelu(x, approximate="tanh"),
    "ELU": F.elu,
    "LeakyReLU": lambda x: F.leaky_relu(x, negative_slope=0.01),
    "Sigmoid": torch.sigmoid,
    "Tanh": torch.tanh,
    "Mish": lambda x: x * torch.tanh(F.softplus(x)),
}


def get_activation(name: str) -> T.Callable[[Tensor], Tensor]:
    try:
        return _ACTIVATIONS[name]
    except KeyError as e:
        raise ValueError(
            f"Unknown activation {name!r}; choose from {sorted(_ACTIVATIONS)}"
        ) from e
