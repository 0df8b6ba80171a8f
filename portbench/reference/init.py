"""Seeded weight initialization mirroring cultionet_tpu/nn/init.py.

Reference scheme (layers/weights.py:24-39 of the reference library):
Kaiming-normal (fan_in, a=0) conv/linear weights, standard-normal biases,
BatchNorm scale ~ N(1, 0.02) and zero BN bias; LayerNorm starts at
(1, 0) and the learnable gammas at 1, the spatial-channel gate's at 0
(set where they are created).
Exceptions, as the JAX modules declare them: a ``LecunLinear`` (a flax
``nn.Dense`` left at flax's default init) gets lecun-normal weights and zero
biases, and a module's ``normal_init`` names parameters drawn from
N(0, std) (the TemporalTransformer's ``pool_query``, std 0.02).
Draws come from an explicit ``torch.Generator``; they do not reproduce the
JAX package's random streams (tests translate JAX weights instead).
"""

import math

import torch
from torch import nn

Tensor = torch.Tensor


def _randn(like: Tensor, generator: torch.Generator) -> Tensor:
    draw = torch.randn(
        like.shape, generator=generator, device=generator.device
    )
    return draw.to(device=like.device, dtype=like.dtype)


@torch.no_grad()
def kaiming_normal_(
    weight: Tensor, fan_in: int, generator: torch.Generator
) -> Tensor:
    """He-normal over ``fan_in`` (torch kaiming_normal_(a=0, mode='fan_in'))."""
    return weight.copy_(_randn(weight, generator) * math.sqrt(2.0 / fan_in))


@torch.no_grad()
def normal_bias_(bias: Tensor, generator: torch.Generator) -> Tensor:
    """Standard-normal bias."""
    return bias.copy_(_randn(bias, generator))


@torch.no_grad()
def lecun_normal_(
    weight: Tensor, fan_in: int, generator: torch.Generator
) -> Tensor:
    """flax's default Dense kernel init: variance_scaling(1, "fan_in",
    "truncated_normal"), a normal truncated at two standard deviations and
    rescaled to variance 1 / fan_in."""
    draw = _randn(weight, generator)
    outside = draw.abs() > 2.0
    while bool(outside.any()):
        draw[outside] = _randn(draw[outside], generator)
        outside = draw.abs() > 2.0
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return weight.copy_(draw * std)


@torch.no_grad()
def batchnorm_scale_(weight: Tensor, generator: torch.Generator) -> Tensor:
    """BatchNorm scale ~ N(1, 0.02)."""
    return weight.copy_(1.0 + 0.02 * _randn(weight, generator))


class LecunLinear(nn.Linear):
    """An ``nn.Linear`` that ``init_parameters_`` initializes as flax
    initializes a ``nn.Dense`` with its default init: lecun-normal weight,
    zero bias."""


def _fan_in(module: nn.Module) -> int:
    weight = module.weight
    receptive = math.prod(weight.shape[2:])
    if isinstance(module, nn.ConvTranspose2d):
        # (I, O, kh, kw): the flax kernel (kh, kw, I, O) takes fan_in over I.
        return weight.shape[0] * receptive
    return weight.shape[1] * receptive


@torch.no_grad()
def init_parameters_(
    module: nn.Module, generator: torch.Generator
) -> nn.Module:
    """Initialize every conv, linear and norm layer of ``module`` in place,
    in module order, from ``generator``."""
    for m in module.modules():
        if isinstance(m, LecunLinear):
            lecun_normal_(m.weight, _fan_in(m), generator)
            m.bias.zero_()
        elif isinstance(
            m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.Linear)
        ):
            kaiming_normal_(m.weight, _fan_in(m), generator)
            if m.bias is not None:
                normal_bias_(m.bias, generator)
        elif isinstance(m, nn.BatchNorm2d):
            batchnorm_scale_(m.weight, generator)
            m.bias.zero_()
            m.reset_running_stats()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        for name, std in getattr(m, "normal_init", {}).items():
            param = getattr(m, name)
            param.copy_(std * _randn(param, generator))
    return module
