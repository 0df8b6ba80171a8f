"""The control of a train cell whose program computes its backward in
the compute type as well: the reference trained in fp8, forward and
backward.

``lowp.py`` rounds the parameters and every leaf module's output to fp8
and passes gradients through unchanged, so its backward runs in fp32.
A "16-mixed" program runs its backward in bf16 too, and in a network of
ReLUs (U-TAE) most of its gap to the fp32 reference comes from there:
the forward's rounding moves activations across the ReLUs' kinks and the
backward's rounding compounds through the layers. Inside
``fp8_train_compute(model)`` the parameters and every leaf module's
output are rounded to fp8 E4M3 as in ``lowp.py``, and the gradient that
flows back into each leaf module's output is rounded to fp8 E5M2 (one
scale per tensor): the formats of fp8 training. Gradients land on the
fp32 parameters, which are restored on exit; an optimizer steps after
exit on the fp32 parameters.
"""

import contextlib
import typing as T

import torch

from .lowp import round_fp8

Tensor = torch.Tensor

E5M2 = torch.float8_e5m2
E5M2_MAX = 57344.0


def round_e5m2(x: Tensor) -> Tensor:
    """``x`` rounded to e5m2 at a per-tensor scale, in x's dtype."""
    if not x.is_floating_point() or x.numel() == 0:
        return x
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = amax / E5M2_MAX
    return ((x.float() / scale).to(E5M2).float() * scale).to(x.dtype)


class _Fp8Train(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: Tensor) -> Tensor:
        return round_fp8(x)

    @staticmethod
    def backward(ctx, grad: Tensor) -> Tensor:
        return round_e5m2(grad)


def _round_output(module, args, output):
    if isinstance(output, Tensor):
        return _Fp8Train.apply(output) if output.is_floating_point() else output
    return output


@contextlib.contextmanager
def fp8_train_compute(model: torch.nn.Module) -> T.Iterator[None]:
    masters = {}
    hooks = []
    try:
        with torch.no_grad():
            for name, p in model.named_parameters():
                masters[name] = p.data
                p.data = round_fp8(p.data)
        for module in model.modules():
            if not list(module.children()):
                hooks.append(module.register_forward_hook(_round_output))
        yield
    finally:
        for hook in hooks:
            hook.remove()
        for name, p in model.named_parameters():
            if name in masters:
                p.data = masters[name]
