"""flax -> torch weight translator for the ported model family.

The port names its submodules after the flax scopes, so a flax variable
path joined with dots is the torch ``state_dict`` key, up to the leaf
name and layout:

  Conv          (kh, kw, I, O)       -> (O, I, kh, kw)
  Conv3d        (kT, 1, 1, I, O)     -> (O, I, kT, 1, 1)
  ConvTranspose (kh, kw, I, O)       -> spatial flip undone, (I, O, kh, kw)
                (the inverse of cultionet_tpu/utils/torch_params.py)
  Dense         (I, O)               -> (O, I)
  BatchNorm     scale/bias, mean/var -> weight/bias, running_mean/var
  LayerNorm     scale/bias           -> weight/bias
  gammas        (1,)                 -> as they are

Variables come as the JAX ``{"params": ..., "batch_stats": ...}`` trees:
nested mappings of arrays (numpy, or anything ``np.asarray`` reads).
"""

import typing as T

import numpy as np
import torch
from torch import nn

_LEAVES = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def _walk(tree: T.Mapping, prefix: T.Tuple[str, ...] = ()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, T.Mapping):
            yield from _walk(value, path)
        else:
            yield path, value


def _layout(scope: T.Sequence[str], leaf: str, value: np.ndarray):
    if leaf != "kernel":
        return value
    if value.ndim == 2:  # Dense
        return value.T
    if scope[-1].startswith("ConvTranspose"):
        return value[::-1, ::-1].transpose(2, 3, 0, 1)
    if value.ndim == 4:
        return value.transpose(3, 2, 0, 1)
    if value.ndim == 5:
        return value.transpose(4, 3, 0, 1, 2)
    raise ValueError(
        f"{'/'.join(scope)}/kernel: unexpected rank {value.ndim}"
    )


def from_flax(
    variables: T.Mapping[str, T.Mapping],
) -> T.Dict[str, torch.Tensor]:
    """Translate JAX variables into a torch ``state_dict`` (fp32 tensors,
    keys ``scope.scope.leaf``)."""
    state: T.Dict[str, torch.Tensor] = {}
    for collection, tree in variables.items():
        if collection not in ("params", "batch_stats"):
            raise ValueError(f"unknown variable collection {collection!r}")
        for (*scope, leaf), value in _walk(tree):
            name = _LEAVES.get((collection, leaf), leaf)
            value = _layout(scope, leaf, np.asarray(value, dtype=np.float32))
            state[".".join([*scope, name])] = torch.from_numpy(
                np.array(value, order="C")
            )
    return state


def load_flax(module: nn.Module, variables: T.Mapping[str, T.Mapping]):
    """Load JAX variables into ``module`` (``strict=True``).

    Raises ``ValueError`` naming every flax leaf the module has no place
    for; ``load_state_dict`` raises on anything the variables lack.
    BatchNorm's ``num_batches_tracked`` has no flax counterpart and is set
    to 0.
    """
    state = from_flax(variables)
    expected = module.state_dict()
    unconsumed = sorted(key for key in state if key not in expected)
    if unconsumed:
        raise ValueError(
            "flax leaves with no place in the torch module: "
            + ", ".join(unconsumed)
        )
    for key, value in expected.items():
        if key.endswith("num_batches_tracked") and key not in state:
            state[key] = torch.zeros_like(value)
    module.load_state_dict(state, strict=True)
    return module
