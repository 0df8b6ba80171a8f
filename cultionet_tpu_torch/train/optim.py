"""Optimizer and learning-rate schedules (port of
cultionet_tpu/train/optim.py, where they are optax transformations).

Schedules are functions of the optimizer's update count, equal to the optax
ones step for step. ``build_optimizer`` returns an ``OptimizerSpec``, the
counterpart of the optax chain: ``spec.init(params)`` binds it to the
parameters as an ``Optimizer`` whose ``step()`` reads their ``.grad``, and
applies, in the optax order, gradient accumulation (``optax.MultiSteps``:
the running mean of ``k`` mini-step gradients), clipping (global norm or
per element) and the torch optimizer, with the learning rate and AdamW's
beta1 set from their schedules at the update count before each update.
"""

import dataclasses
import math
import typing as T

import torch

from ..enums import LearningRateSchedulers

Tensor = torch.Tensor
Schedule = T.Callable[[int], float]


def _cosine_onecycle(
    transition_steps: int,
    peak_value: float,
    pct_start: float = 0.3,
    div_factor: float = 25.0,
    final_div_factor: float = 1e4,
) -> Schedule:
    """optax.cosine_onecycle_schedule: cosine from peak / div_factor up to
    the peak at ``int(pct_start * transition_steps)``, then down to
    peak / (div_factor * final_div_factor) at ``transition_steps``."""
    bounds = (0, int(pct_start * transition_steps), int(transition_steps))
    # optax accumulates the scales: init, init * div, that / (div * final).
    init = peak_value / div_factor
    peak = init * div_factor
    values = (init, peak, peak / (div_factor * final_div_factor))

    def schedule(step: int) -> float:
        for i in range(2):
            if bounds[i] <= step < bounds[i + 1]:
                pct = (step - bounds[i]) / (bounds[i + 1] - bounds[i])
                start, end = values[i], values[i + 1]
                cos = math.cos(math.pi * pct)
                return end + (start - end) / 2.0 * (cos + 1)
        return values[-1] if step >= bounds[-1] else 0.0

    return schedule


def build_schedule(
    name: str,
    learning_rate: float,
    epochs: int,
    steps_per_epoch: int,
    steplr_step_size: int = 5,
) -> Schedule:
    total_steps = max(1, epochs * steps_per_epoch)

    if name == LearningRateSchedulers.ONE_CYCLE_LR:
        # torch OneCycleLR defaults (pct_start 0.3, div_factor 25,
        # final_div_factor 1e4, cosine), with the JAX package's minimum
        # horizon of 10 steps for tiny runs.
        return _cosine_onecycle(max(total_steps, 10), learning_rate)

    if name == LearningRateSchedulers.COSINE_ANNEALING_LR:
        t_max, eta_min = 20.0, 1e-5

        def cosine(step: int) -> float:
            epoch = min(step // steps_per_epoch, t_max)
            return eta_min + 0.5 * (learning_rate - eta_min) * (
                1.0 + math.cos(math.pi * epoch / t_max)
            )

        return cosine

    if name in (
        LearningRateSchedulers.EXPONENTIAL_LR,
        LearningRateSchedulers.STEP_LR,
    ):
        period = steps_per_epoch * (
            steplr_step_size if name == LearningRateSchedulers.STEP_LR else 1
        )

        def staircase(step: int) -> float:
            if step <= 0:
                return learning_rate
            return learning_rate * 0.5 ** math.floor(step / period)

        return staircase

    raise ValueError(f"Unknown LR scheduler: {name}")


def build_momentum_schedule(
    name: str, epochs: int, steps_per_epoch: int
) -> T.Optional[Schedule]:
    """OneCycle's momentum cycle (torch ``cycle_momentum``): AdamW's beta1
    from 0.95 down to 0.85 over the 30% warmup, back to 0.95 by the end."""
    if name != LearningRateSchedulers.ONE_CYCLE_LR:
        return None
    total = max(epochs * steps_per_epoch, 10)
    warm = int(total * 0.3)

    def schedule(step: int) -> float:
        step = min(step, total)
        if step < warm:
            return 0.95 + (0.85 - 0.95) * (step / max(warm, 1))
        frac = (step - warm) / max(total - warm, 1)
        return 0.85 + (0.95 - 0.85) * 0.5 * (1 - math.cos(math.pi * frac))

    return schedule


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """What ``build_optimizer`` was asked for; ``init`` binds it."""

    optimizer: str
    learning_rate: T.Union[float, Schedule]
    weight_decay: float
    eps: float
    gradient_clip_val: T.Optional[float]
    gradient_clip_algorithm: str
    accumulate_grad_batches: int
    b1_schedule: T.Optional[Schedule]

    def init(self, params: T.Iterable[Tensor]) -> "Optimizer":
        return Optimizer(list(params), self)


def build_optimizer(
    optimizer: str = "AdamW",
    learning_rate: T.Union[float, Schedule] = 1e-2,
    weight_decay: float = 1e-4,
    eps: float = 1e-4,
    gradient_clip_val: T.Optional[float] = None,
    gradient_clip_algorithm: str = "norm",
    accumulate_grad_batches: int = 1,
    b1_schedule: T.Optional[Schedule] = None,
) -> OptimizerSpec:
    """Adam (0.9, 0.999), AdamW (0.9 or ``b1_schedule``, 0.98) with
    decoupled weight decay, or SGD (momentum 0.9, coupled decay), as the
    JAX package builds them with optax. RAdam is not ported yet."""
    if optimizer == "RAdam":
        raise NotImplementedError("RAdam is not ported yet")
    if optimizer not in ("Adam", "AdamW", "SGD"):
        raise NameError("Choose 'Adam', 'AdamW', 'RAdam', or 'SGD'.")
    if gradient_clip_algorithm not in ("norm", "value"):
        raise ValueError(
            f"gradient_clip_algorithm must be 'norm' or 'value', got "
            f"{gradient_clip_algorithm!r}"
        )
    return OptimizerSpec(
        optimizer,
        learning_rate,
        weight_decay,
        eps,
        gradient_clip_val,
        gradient_clip_algorithm,
        max(1, accumulate_grad_batches),
        b1_schedule,
    )


class Optimizer:
    """An ``OptimizerSpec`` bound to parameters. ``count`` is the number of
    updates applied (optax's inner count); the schedules are read at it."""

    def __init__(self, params: T.List[Tensor], spec: OptimizerSpec):
        self.params = params
        self.spec = spec
        self.count = 0
        self.mini_step = 0
        self._acc: T.Optional[T.List[Tensor]] = None
        lr = self._learning_rate()
        if spec.optimizer == "AdamW":
            self.torch_optimizer = torch.optim.AdamW(
                params,
                lr=lr,
                betas=(self._beta1(), 0.98),
                eps=spec.eps,
                weight_decay=spec.weight_decay,
            )
        elif spec.optimizer == "Adam":
            self.torch_optimizer = torch.optim.Adam(
                params, lr=lr, betas=(0.9, 0.999), eps=spec.eps
            )
        else:
            self.torch_optimizer = torch.optim.SGD(
                params, lr=lr, momentum=0.9, weight_decay=spec.weight_decay
            )

    def _learning_rate(self) -> float:
        lr = self.spec.learning_rate
        return float(lr(self.count)) if callable(lr) else float(lr)

    def _beta1(self) -> float:
        b1 = self.spec.b1_schedule
        return 0.9 if b1 is None else float(b1(self.count))

    def _grads(self) -> T.List[Tensor]:
        return [
            torch.zeros_like(p) if p.grad is None else p.grad
            for p in self.params
        ]

    def _clip(self, grads: T.List[Tensor]) -> T.List[Tensor]:
        limit = self.spec.gradient_clip_val
        if limit is None:
            return grads
        if self.spec.gradient_clip_algorithm == "value":
            return [g.clamp(-limit, limit) for g in grads]
        # optax.clip_by_global_norm: scale by limit / norm when the norm
        # reaches the limit; on the device, without a host sync, with a
        # few multi-tensor launches whatever the number of tensors.
        norm = torch.nn.utils.get_total_norm(grads)
        scale = torch.where(norm < limit, torch.ones_like(norm), limit / norm)
        return torch._foreach_mul(grads, scale)

    @torch.no_grad()
    def step(self) -> bool:
        """Consume the parameters' gradients; returns whether an update was
        applied (with accumulation, only every k-th call updates)."""
        grads = self._grads()
        k = self.spec.accumulate_grad_batches
        if k > 1:
            n = self.mini_step
            if self._acc is None:
                self._acc = [torch.zeros_like(g) for g in grads]
            self._acc = [
                acc + (g - acc) / (n + 1) for g, acc in zip(grads, self._acc)
            ]
            self.mini_step = (n + 1) % k
            self.zero_grad()
            if n != k - 1:
                return False
            grads, self._acc = self._acc, None

        for group in self.torch_optimizer.param_groups:
            group["lr"] = self._learning_rate()
            if self.spec.optimizer == "AdamW":
                group["betas"] = (self._beta1(), group["betas"][1])
        for p, g in zip(self.params, self._clip(grads)):
            p.grad = g
        self.torch_optimizer.step()
        self.zero_grad()
        self.count += 1
        return True

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None
