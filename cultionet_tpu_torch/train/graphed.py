"""The device-resident train step replayed as one CUDA graph.

The step over a resident split (``step.py::make_hbm_train_step``) reads
fixed shapes from the device and draws all its randomness from one CUDA
generator, so its launches (the gather, the in-step augmentation, the
forward, the loss, the backward, the clip and the optimizer's update) can
be captured once and replayed: the host then issues one graph launch a
step where the eager step issues some twenty thousand operators.

- ``eager_reason``: why a call must run eagerly, from what the call can
  observe, or None where a graph is safe: the plain train step (no
  gradient all-reduce), an update on device scalars
  (``optim.py::Optimizer.device_scalars``: Adam or AdamW over unsharded
  parameters; RAdam and SGD read their hyperparameters on the host), no
  gradient accumulation, no rematerialized segment, the hand-written
  kernels on, and the indices, parameters and generator on CUDA.
- ``GraphedStep``: per setup (the model, the optimizer and its loads, the
  generator, the resident arrays, the index vector's shape and dtype, the
  kernel switches) the first ``WARMUP`` calls run eagerly on a side
  stream, the next captures the step and replays it, and every later call
  replays: it copies the index vector into the graph's own, fills the
  optimizer's device scalars for the update, replays, and returns clones
  of the logs (the next replay overwrites the graph's). The generator is
  registered with the graph, so each replay draws new numbers; the kernel
  launch counters (``ops/*_cuda.py``) and the Python counters (the
  optimizer's update count, the state's step) advance as an eager step
  advances them. Another setup drops the graph and starts over.
"""

import typing as T

import torch

from ..ops import flags
from ..utils import profiling
from ..utils.profiling import span

Tensor = torch.Tensor
WARMUP = 2


def _launch_tables() -> T.Tuple[T.Dict[str, int], ...]:
    from ..ops import na_block_cuda, natten_cuda, temporal_cuda

    return (natten_cuda.LAUNCHES, temporal_cuda.LAUNCHES, na_block_cuda.LAUNCHES)


def _kernels_on() -> bool:
    return (
        flags.cuda_natten_enabled()
        and flags.cuda_temporal_enabled()
        and flags.cuda_na_block_enabled()
    )


def eager_reason(state, inner, indices: Tensor, generator) -> T.Optional[str]:
    """Why ``inner`` (the train step over a gathered batch) cannot be
    replayed as a graph on this call; None where it can."""
    model, optimizer = state.model, state.optimizer
    if getattr(inner, "reduce_gradients", True) is not None:
        return "the step all-reduces gradients or is not make_train_step's"
    if not getattr(optimizer, "device_scalars", False):
        return "the optimizer's update reads its scalars on the host"
    if optimizer.spec.accumulate_grad_batches != 1:
        return "gradient accumulation"
    if any(getattr(m, "remat", False) for m in model.modules()):
        return "rematerialized segments"
    if not _kernels_on():
        return "the plain attention path"
    on_cuda = [indices.device, getattr(generator, "device", None)]
    on_cuda += [p.device for p in model.parameters()]
    if any(d is None or d.type != "cuda" for d in on_cuda):
        return "not on CUDA"
    return None


class GraphedStep:
    """``step(state, arrays, indices, generator)`` of ``eager`` (the
    gather and ``inner``), replayed as a CUDA graph where
    ``eager_reason`` finds nothing against it."""

    def __init__(self, eager: T.Callable, inner: T.Callable):
        self.eager = eager
        self.inner = inner
        self.key: T.Optional[tuple] = None
        self.reason: T.Optional[str] = None
        self.calls = 0
        self.graph = None
        self.indices: T.Optional[Tensor] = None
        self.logs: T.Dict[str, Tensor] = {}
        self.launches: T.List[T.Dict[str, int]] = []
        self.stream = None

    def _key(self, state, arrays, indices, generator) -> tuple:
        # The objects themselves, not their ids: the key keeps them alive,
        # so no later object can take a dropped one's place.
        return (
            state.model, state.optimizer, getattr(state.optimizer, "generation", 0),
            generator,
            tuple(indices.shape), indices.dtype, indices.device,
            tuple(v.data_ptr() for v in arrays.values() if v is not None),
            _kernels_on(),
        )

    def plan(self, key: tuple, reason: T.Callable[[], T.Optional[str]]) -> str:
        """What a call with ``key`` does: "eager", "capture" or "replay".
        A new key drops the graph; ``reason`` is asked once per key."""
        if key != self.key:
            # The graph's static tensors go with it (they hold its memory).
            self.key, self.calls, self.graph = key, 0, None
            self.indices, self.logs, self.launches = None, {}, []
            self.reason = reason()
        if self.reason is not None:
            return "eager"
        self.calls += 1
        if self.calls <= WARMUP:
            return "eager"
        return "replay" if self.graph is not None else "capture"

    def __call__(self, state, arrays, indices, generator):
        key = self._key(state, arrays, indices, generator)
        action = self.plan(
            key, lambda: eager_reason(state, self.inner, indices, generator)
        )
        if action == "eager":
            if self.reason is not None:
                return self.eager(state, arrays, indices, generator)
            return self._on_side_stream(
                lambda: self.eager(state, arrays, indices, generator)
            )
        if action == "capture":
            self._capture(state, arrays, indices, generator)
        else:
            with span("train.replay"):
                self._replay(state, indices)
        return state, {name: value.clone() for name, value in self.logs.items()}

    def _side_stream(self) -> "torch.cuda.Stream":
        """The stream of the warm-up calls and of the capture, as CUDA
        graph capture asks (lazy set-up bound to a stream happens there)."""
        if self.stream is None:
            self.stream = torch.cuda.Stream()
        return self.stream

    def _on_side_stream(self, fn: T.Callable):
        side, main = self._side_stream(), torch.cuda.current_stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = fn()
        main.wait_stream(side)
        return out

    def _capture(self, state, arrays, indices, generator) -> None:
        self.indices = indices.clone()
        before = [dict(table) for table in _launch_tables()]
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(generator)
        # The captured update reads the scalars filled here, and each
        # replay's update those filled before it. Capture starts with a
        # device synchronize, so the fills and the clone are done.
        state.optimizer.fill_scalars()
        with torch.cuda.graph(graph, stream=self._side_stream()):
            _, logs = self.eager(state, arrays, self.indices, generator)
        self.logs = logs
        self.launches = [
            {k: table[k] - old.get(k, 0) for k in table if table[k] != old.get(k, 0)}
            for table, old in zip(_launch_tables(), before)
        ]
        self.graph = graph
        profiling.add_count("graph_captures")
        # The capture ran the step's Python (its counters moved) and
        # recorded its launches; the replay runs them.
        graph.replay()
        profiling.add_count("graph_replays")

    def _replay(self, state, indices) -> None:
        self.indices.copy_(indices)
        state.optimizer.fill_scalars()
        state.model.train()
        self.graph.replay()
        state.optimizer.count += 1
        state.step += 1
        profiling.add_count("graph_replays")
        for table, moved in zip(_launch_tables(), self.launches):
            for name, n in moved.items():
                table[name] += n
