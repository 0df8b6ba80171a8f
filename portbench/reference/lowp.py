"""The control of the comparison: the reference computed in fp8.

The configurations state bf16 compute ("16-mixed" training, bf16
predict and serve); the nearest precision below it is fp8. Inside
``fp8_compute(model)`` every parameter is rounded to fp8 (e4m3, one
scale per tensor, as an fp8 copy of the fp32 weights would be) and the
output of every leaf module is rounded the same way; gradients pass the
roundings unchanged and land on the fp32 parameters, which are restored
on exit. An optimizer steps after exit, on the fp32 parameters
(``ReferenceTrainer``'s ``compute``), so no update is lost. A sound bf16 program lies far closer to the fp32 reference
than this does, so every comparison limit sits between the two.
"""

import contextlib
import typing as T

import torch

Tensor = torch.Tensor

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


def round_fp8(x: Tensor) -> Tensor:
    """``x`` rounded to e4m3 at a per-tensor scale, in x's dtype."""
    if not x.is_floating_point() or x.numel() == 0:
        return x
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = amax / FP8_MAX
    return ((x.float() / scale).to(FP8).float() * scale).to(x.dtype)


def _straight_through(x: Tensor) -> Tensor:
    return x + (round_fp8(x) - x).detach()


def _round_output(module, args, output):
    if isinstance(output, Tensor):
        return _straight_through(output)
    if isinstance(output, dict):
        return {
            k: (_straight_through(v) if isinstance(v, Tensor) else v)
            for k, v in output.items()
        }
    return output


@contextlib.contextmanager
def fp8_compute(model: torch.nn.Module) -> T.Iterator[None]:
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
