"""Seeded weights for both sides, made on the device.

``seeded_state`` draws every floating parameter of the CLI-default model
from one generator on the card in one call, scales each leaf by its
kind (He-normal convolutions and linear layers over their fan-in, as the
program initializes them, LeCun-normal for the temporal transformer's
dense layers, normalization scales near 1, small biases), then sets the
BatchNorm running statistics to the statistics of a batch of the cell's
own inputs, so that an eval forward sees normalized activations, as a
trained checkpoint's would. The program and the reference load the same
state dict.
"""

import math
import typing as T

import torch
from torch import nn

from .reference.blocks import BatchNorm
from .reference.init import LecunLinear

Tensor = torch.Tensor


def reference_model(config: T.Mapping[str, T.Any], device) -> nn.Module:
    """The reference CultioNet of ``config["model"]``, fp32, on
    ``device`` (built on the meta device, storage left unset)."""
    from .reference.cultionet import CultioNet

    with torch.device("meta"):
        model = CultioNet(**config["model"])
    return model.to_empty(device=device)


def _scale(module: nn.Module, leaf: str, shape) -> T.Tuple[float, float]:
    """(std, mean) of the leaf's draw."""
    if leaf == "bias":
        return 0.1, 0.0
    if isinstance(module, (nn.BatchNorm2d, nn.LayerNorm)):
        return 0.02, 1.0
    if isinstance(module, (nn.Conv2d, nn.Linear, nn.ConvTranspose2d)):
        receptive = math.prod(shape[2:])
        fan_in = shape[0 if isinstance(module, nn.ConvTranspose2d) else 1]
        gain = 1.0 if isinstance(module, LecunLinear) else 2.0
        return math.sqrt(gain / (fan_in * receptive)), 0.0
    if "gamma" in leaf:  # temperatures and tower weights that divide
        return 0.02, 1.0
    return 0.02, 0.0


@torch.no_grad()
def seeded_state(
    model: nn.Module, seed: int, calibration_x: Tensor
) -> T.Dict[str, Tensor]:
    """Draw ``model``'s parameters from ``seed`` on its device, calibrate
    its BatchNorm statistics on ``calibration_x`` (a model input, fp32),
    and return its state dict (fp32 tensors the caller may copy)."""
    device = next(model.parameters()).device
    modules = dict(model.named_modules())
    named = list(model.named_parameters())
    total = sum(p.numel() for _, p in named)
    generator = torch.Generator(device=device).manual_seed(int(seed))
    draw = torch.randn(total, generator=generator, device=device)
    offset = 0
    for name, p in named:
        owner, _, leaf = name.rpartition(".")
        std, mean = _scale(modules[owner], leaf, p.shape)
        p.copy_(draw[offset: offset + p.numel()].view(p.shape) * std + mean)
        offset += p.numel()
    for module in model.modules():
        if isinstance(module, nn.BatchNorm2d):
            module.running_mean.zero_()
            module.running_var.fill_(1.0)
            module.num_batches_tracked.zero_()

    def calibrate(module, args):
        x = args[0]
        x4 = x.flatten(2, 3) if x.dim() == 5 else x
        var, mean = torch.var_mean(x4.float(), dim=(0, 2, 3), correction=0)
        module.BatchNorm_0.running_mean.copy_(mean)
        module.BatchNorm_0.running_var.copy_(var)

    hooks = [
        m.register_forward_pre_hook(calibrate)
        for m in model.modules() if isinstance(m, BatchNorm)
    ]
    try:
        model.eval()
        model(calibration_x)
    finally:
        for hook in hooks:
            hook.remove()
    return {k: v.detach().clone() for k, v in model.state_dict().items()}
