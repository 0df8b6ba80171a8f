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
RAdam is optax's rule (``OptaxRAdam``), which ``torch.optim.RAdam`` is not.
Under FSDP (``parallel/mesh.py::shard_state_fsdp``) the sharded parameters
are DTensors: the global norm sums every shard's squares over the group,
and the torch optimizer runs its per-tensor loop (its multi-tensor kernels
refuse a mix of DTensors and tensors).

Adam and AdamW on unsharded parameters apply the update themselves
(``Optimizer.device_scalars``), on every device: torch's multi-tensor
arithmetic, with the scalars that change from step to step (the learning
rate, AdamW's scheduled beta1 and the bias corrections) read from 0-d
tensors beside the parameters that ``fill_scalars`` sets before each
update. A CUDA graph of the train step (``train/graphed.py``) then replays
each step's schedule; torch's own multi-tensor and fused Adam read a
tensor beta1 on the host, which a capture refuses. The torch optimizer
holds the state, so ``state_dict`` keeps its layout; it runs its own
update only on FSDP's DTensors.
"""

import dataclasses
import itertools
import math
import typing as T

import torch
import torch.distributed as dist

from ..enums import LearningRateSchedulers
from ..parallel.mesh import full_tensor, is_sharded, local_part, shard_like

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

    if name == LearningRateSchedulers.CONSTANT:
        # U-TAE's published run: no scheduler.
        return lambda step: learning_rate

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

    def init(
        self,
        params: T.Iterable[Tensor],
        trainable: T.Optional[T.Sequence[bool]] = None,
    ) -> "Optimizer":
        """Bind to ``params``; where ``trainable`` is False the parameter
        receives no update (optax's ``masked(set_to_zero())`` after the
        chain: its gradient still counts in the global-norm clip)."""
        return Optimizer(list(params), self, trainable)


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
    decoupled weight decay, RAdam (0.9, 0.99) with decoupled weight decay,
    or SGD (momentum 0.9, coupled decay), as the JAX package builds them
    with optax."""
    if optimizer not in ("Adam", "AdamW", "RAdam", "SGD"):
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


class OptaxRAdam(torch.optim.Optimizer):
    """Rectified Adam as the JAX package chains it:
    ``optax.scale_by_radam(b1, b2, eps)``, then
    ``add_decayed_weights(weight_decay)``, then the learning rate.

    ``torch.optim.RAdam`` differs: it adds ``eps`` to ``sqrt(v)`` before the
    bias correction and rectifies where ``rho > 5``; optax divides the
    bias-corrected first moment by ``sqrt(v_hat) + eps`` and rectifies
    where ``rho >= 5``. A parameter without a gradient is skipped (a frozen
    one: optax's mask zeroes its update)."""

    B1 = 0.9
    B2 = 0.99
    RHO_THRESHOLD = 5.0

    def __init__(self, params, lr: float, eps: float, weight_decay: float):
        super().__init__(params, dict(lr=lr, eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self) -> None:
        b1, b2 = self.B1, self.B2
        for group in self.param_groups:
            rho_inf = 2.0 / (1.0 - b2) - 1.0
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = torch.tensor(0.0)
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                t = int(state["step"])
                mu, nu = state["exp_avg"], state["exp_avg_sq"]
                mu.mul_(b1).add_(p.grad, alpha=1.0 - b1)
                nu.mul_(b2).addcmul_(p.grad, p.grad, value=1.0 - b2)
                b2t = b2**t
                rho = rho_inf - 2.0 * t * b2t / (1.0 - b2t)
                update = mu / (1.0 - b1**t)
                if rho >= self.RHO_THRESHOLD:
                    rect = math.sqrt(
                        (rho - 4.0) * (rho - 2.0) * rho_inf
                        / ((rho_inf - 4.0) * (rho_inf - 2.0) * rho)
                    )
                    nu_hat = nu / (1.0 - b2t)
                    update = rect * update / (nu_hat.sqrt() + group["eps"])
                update = update + group["weight_decay"] * p
                p.sub_(group["lr"] * update)


def global_norm(grads: T.List[Tensor]) -> Tensor:
    """The L2 norm of all of ``grads``; a DTensor's shards count once each,
    their squares summed over the process group."""
    sharded = [local_part(g) for g in grads if is_sharded(g)]
    if not sharded:
        return torch.nn.utils.get_total_norm(grads)
    squares = torch.nn.utils.get_total_norm(sharded) ** 2
    dist.all_reduce(squares)
    plain = [g for g in grads if not is_sharded(g)]
    if plain:
        squares = squares + torch.nn.utils.get_total_norm(plain) ** 2
    return squares.sqrt()


def _on_device_scalars(params: T.List[Tensor], spec: OptimizerSpec) -> bool:
    """Whether Adam's update runs on device scalars: Adam or AdamW over
    parameters none of which is sharded."""
    return (
        spec.optimizer in ("Adam", "AdamW")
        and bool(params)
        and not any(is_sharded(p) for p in params)
    )


class Optimizer:
    """An ``OptimizerSpec`` bound to parameters. ``count`` is the number of
    updates applied (optax's inner count); the schedules are read at it.
    ``generation`` counts ``load_state_dict`` calls, which replace the
    state's tensors."""

    def __init__(
        self,
        params: T.List[Tensor],
        spec: OptimizerSpec,
        trainable: T.Optional[T.Sequence[bool]] = None,
    ):
        self.params = params
        self.spec = spec
        if trainable is None:
            trainable = [True] * len(params)
        if len(trainable) != len(params):
            raise ValueError("one trainable flag per parameter")
        self.trainable = list(trainable)
        self.count = 0
        self.mini_step = 0
        self.generation = 0
        self._acc: T.Optional[T.List[Tensor]] = None
        lr = self._learning_rate()
        foreach = False if any(is_sharded(p) for p in params) else None
        self.device_scalars = _on_device_scalars(params, spec)
        if self.device_scalars:
            # The update's scalars, filled before each update.
            self.scalars = {
                name: torch.zeros((), dtype=torch.float32, device=params[0].device)
                for name in ("decay", "beta1", "one_minus_beta1", "bc2_sqrt",
                             "neg_step_size")
            }
        if spec.optimizer == "AdamW":
            self.torch_optimizer = torch.optim.AdamW(
                params,
                lr=lr,
                betas=(self._beta1(), 0.98),
                eps=spec.eps,
                weight_decay=spec.weight_decay,
                foreach=foreach,
                # Loads put the step counts beside the parameters.
                capturable=self.device_scalars,
            )
        elif spec.optimizer == "Adam":
            self.torch_optimizer = torch.optim.Adam(
                params, lr=lr, betas=(0.9, 0.999), eps=spec.eps,
                foreach=foreach, capturable=self.device_scalars,
            )
        elif spec.optimizer == "RAdam":
            self.torch_optimizer = OptaxRAdam(
                params, lr=lr, eps=spec.eps, weight_decay=spec.weight_decay
            )
        else:
            self.torch_optimizer = torch.optim.SGD(
                params, lr=lr, momentum=0.9, weight_decay=spec.weight_decay,
                foreach=foreach,
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
        norm = global_norm(grads)
        scale = torch.where(norm < limit, torch.ones_like(norm), limit / norm)
        torch._foreach_mul_([local_part(g) for g in grads], scale)
        return grads

    def fill_scalars(self) -> None:
        """Set the device scalars of the next update (update ``count + 1``)
        from the schedules, in place; each is computed in float64 on the
        host, as torch's multi-tensor Adam computes them, and rounded to
        fp32 once. Plain Adam keeps beta1 at 0.9 (``build_optimizer``)."""
        group = self.torch_optimizer.param_groups[0]
        lr = self._learning_rate()
        b1 = self._beta1() if self.spec.optimizer == "AdamW" else 0.9
        b2 = group["betas"][1]
        t = self.count + 1
        values = {
            "decay": 1.0 - lr * group["weight_decay"],
            "beta1": b1,
            "one_minus_beta1": 1.0 - b1,
            "bc2_sqrt": math.sqrt(1.0 - b2**t),
            "neg_step_size": -lr / (1.0 - b1**t),
        }
        for name, value in values.items():
            self.scalars[name].fill_(value)

    def _adam_update(self, params: T.List[Tensor], grads: T.List[Tensor]) -> None:
        """Adam's update (AdamW's: decoupled weight decay) with torch's
        multi-tensor ops and state, on the device scalars. The first moment
        is ``beta1 m + (1 - beta1) g`` (torch interpolates: the same up to
        rounding)."""
        opt = self.torch_optimizer
        group = opt.param_groups[0]
        b2 = group["betas"][1]
        steps, exp_avgs, exp_avg_sqs = [], [], []
        for p in params:
            slot = opt.state[p]
            if not slot:
                slot["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
                slot["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                slot["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            steps.append(slot["step"])
            exp_avgs.append(slot["exp_avg"])
            exp_avg_sqs.append(slot["exp_avg_sq"])
        s = self.scalars
        torch._foreach_add_(steps, 1.0)
        if group["weight_decay"] != 0 and self.spec.optimizer == "AdamW":
            torch._foreach_mul_(params, s["decay"])
        torch._foreach_mul_(exp_avgs, s["beta1"])
        torch._foreach_add_(exp_avgs, torch._foreach_mul(grads, s["one_minus_beta1"]))
        torch._foreach_mul_(exp_avg_sqs, b2)
        torch._foreach_addcmul_(exp_avg_sqs, grads, grads, 1.0 - b2)
        denom = torch._foreach_sqrt(exp_avg_sqs)
        torch._foreach_div_(denom, s["bc2_sqrt"])
        torch._foreach_add_(denom, group["eps"])
        # p + m / (denom / -step_size): torch's capturable form.
        torch._foreach_div_(denom, s["neg_step_size"])
        torch._foreach_addcdiv_(params, exp_avgs, denom)

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

        if self.device_scalars:
            # A CUDA graph's capture must not record the fills: the replay's
            # caller fills them for each replayed update.
            device = self.scalars["beta1"].device
            if not (device.type == "cuda" and torch.cuda.is_current_stream_capturing()):
                self.fill_scalars()
            grads = self._clip(grads)
            self._adam_update(
                list(itertools.compress(self.params, self.trainable)),
                list(itertools.compress(grads, self.trainable)),
            )
            self.zero_grad()
            self.count += 1
            return True

        for group in self.torch_optimizer.param_groups:
            group["lr"] = self._learning_rate()
            if self.spec.optimizer == "AdamW":
                group["betas"] = (self._beta1(), group["betas"][1])
        for p, g, train in zip(self.params, self._clip(grads), self.trainable):
            p.grad = g if train else None  # torch skips a None gradient
        self.torch_optimizer.step()
        self.zero_grad()
        self.count += 1
        return True

    def state_dict(self) -> dict:
        """Everything ``step`` carries between calls: the torch optimizer's
        state, the update count, the accumulation position and sums. Under
        FSDP the sharded moments are gathered whole (a collective: every
        rank calls it), so the dict is a single card's."""
        state = self.torch_optimizer.state_dict()
        state["state"] = {
            index: {name: full_tensor(value) for name, value in slot.items()}
            for index, slot in state["state"].items()
        }
        return {
            "torch_optimizer": state,
            "count": self.count,
            "mini_step": self.mini_step,
            "acc": None if self._acc is None else [full_tensor(a) for a in self._acc],
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore ``state_dict``'s output (or ``convert_orbax.py``'s); whole
        moments of a parameter that FSDP shards are sharded as it is. The
        hyperparameters stay this optimizer's (its spec's): only the state
        is read."""
        torch_state = dict(state["torch_optimizer"])
        torch_state["param_groups"] = [
            {**group, "params": saved["params"]}
            for group, saved in zip(
                self.torch_optimizer.state_dict()["param_groups"],
                torch_state["param_groups"],
            )
        ]
        torch_state["state"] = {
            index: {
                name: shard_like(value, self.params[int(index)])
                if value.dim() > 0
                else value
                for name, value in slot.items()
            }
            for index, slot in torch_state["state"].items()
        }
        self.torch_optimizer.load_state_dict(torch_state)
        self.generation += 1
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        acc = state["acc"]
        self._acc = (
            None
            if acc is None
            else [
                shard_like(a.to(p.device), p) for a, p in zip(acc, self.params)
            ]
        )

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None
