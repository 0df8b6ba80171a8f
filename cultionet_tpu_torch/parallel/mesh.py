"""The data group: batch blocks, global reductions and FSDP (port of
cultionet_tpu/parallel/mesh.py).

JAX lays a 1-D ``data`` mesh over its devices and lets GSPMD insert every
collective from the sharding annotations. Here there is no mesh object:
the data group is the set of ranks of a ``torch.distributed`` process
group, one device each, and the collectives are written out.

- ``shard_batch`` gives rank r the contiguous block r of a global batch,
  as JAX's ``P("data")`` splits the leading axis (not the strided
  interleave of ``DistributedSampler``).
- Inside ``data_parallel()`` the model's cross-sample reductions see
  the whole global batch: ``nn/blocks.py::BatchNorm`` sums its count, sum
  and sum of squares over the group (``global_sum``), and the train and
  eval steps gather the outputs and labels of every rank
  (``gather_for_loss``) before the loss and the metrics, so every loss and
  metric is the one of the global batch. Both collectives carry their
  gradient back to every rank (``torch.autograd.Function``s whose backward
  all-reduces), so the sum of the ranks' gradients is the world size times
  the global one, and ``reduce_gradients`` divides it out.
- FSDP is PyTorch's FSDP2 (``torch.distributed.fsdp.fully_shard``),
  applied to each submodule that owns a parameter of at least
  ``min_size`` elements: its parameters, gradients and optimizer moments
  are sharded along dim 0 over the group (uneven blocks where the group
  does not divide it). JAX shards a large leaf along its largest axis that
  the mesh divides; the math is the same either way. Smaller parameters
  stay replicated, as in JAX, and their gradients are all-reduced with
  the rest.
"""

import contextlib
import typing as T

import torch
import torch.distributed as dist
from torch import nn

from ..data.batch import Batch

Tensor = torch.Tensor

_ACTIVE = False  # inside ``data_parallel`` with more than one rank


def rank_and_world() -> T.Tuple[int, int]:
    """(rank, world size) in the default process group; (0, 1) without
    one."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


@contextlib.contextmanager
def data_parallel() -> T.Iterator[None]:
    """Inside the block the ranks of the default process group are the
    data group: BatchNorm statistics and the steps' losses and metrics are
    taken over the global batch. With one rank the block changes nothing.
    A module-level setting rather than a context variable, so a backward
    on autograd's own thread (a rematerialized segment) sees it too."""
    global _ACTIVE
    previous = _ACTIVE
    _ACTIVE = rank_and_world()[1] > 1
    try:
        yield
    finally:
        _ACTIVE = previous


def data_parallel_active() -> bool:
    """Whether an enclosing ``data_parallel`` block has more than one
    rank."""
    return _ACTIVE


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: Tensor) -> Tensor:
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad: Tensor) -> Tensor:
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


class _GatherBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: Tensor) -> Tensor:
        ctx.rank, ctx.world = rank_and_world()
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(ctx.world)]
        dist.all_gather(parts, x)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad: Tensor) -> Tensor:
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad.chunk(ctx.world)[ctx.rank]


def global_sum(x: Tensor) -> Tensor:
    """``x`` summed over the data group inside ``data_parallel`` (``x``
    itself outside); the gradient of every rank's result reaches every
    rank's ``x``."""
    return _AllReduceSum.apply(x) if data_parallel_active() else x


def gather_blocks(x: Tensor) -> Tensor:
    """The ranks' equal blocks of ``x`` concatenated along dim 0 in rank
    order, with the gradient of the whole returned to each block."""
    return _GatherBlocks.apply(x)


def shard_batch(batch):
    """This rank's contiguous block of a global ``Batch`` (or
    ``data/device_cache.py::IndexBatch``) along the samples. The batch
    size must divide by the world size."""
    rank, world = rank_and_world()
    n = batch.num_samples
    if n % world:
        raise ValueError(
            f"a batch of {n} samples does not split over {world} ranks"
        )
    lo, hi = rank * n // world, (rank + 1) * n // world
    if not isinstance(batch, Batch):
        return type(batch)(batch.indices[lo:hi])
    return batch.replace(
        **{
            name: None if value is None else value[lo:hi]
            for name, value in vars(batch).items()
            if isinstance(value, (Tensor, tuple))
        }
    )


def global_batch_from_local(batch: Batch) -> Batch:
    """The global batch from every rank's equal local block: each tensor
    field gathered in rank order (no gradient); the chip names stay this
    rank's. The counterpart of JAX's name; the port's own steps gather
    only what the loss reads (``gather_for_loss``)."""
    return batch.replace(
        **{
            name: gather_blocks(value.detach())
            for name, value in batch.tensors().items()
        }
    )


def gather_for_loss(
    outputs: T.Dict[str, T.Optional[Tensor]], batch: Batch
) -> T.Tuple[T.Dict[str, T.Optional[Tensor]], Batch]:
    """Inside ``data_parallel``: the model's outputs gathered over the data
    group (their gradient goes back to each rank's block) and the labels the
    loss reads (``y``, ``bdist``). Outside: both as they are."""
    if not data_parallel_active():
        return outputs, batch
    gathered = {
        name: None if value is None else gather_blocks(value)
        for name, value in outputs.items()
    }
    labels = {
        name: gather_blocks(getattr(batch, name).detach())
        for name in ("y", "bdist")
        if getattr(batch, name) is not None
    }
    return gathered, batch.replace(**labels)


_DTENSOR: T.Optional[type] = None


def is_sharded(tensor) -> bool:
    """Whether ``tensor`` is a DTensor (an FSDP2 shard)."""
    global _DTENSOR
    if _DTENSOR is None:
        from torch.distributed.tensor import DTensor

        _DTENSOR = DTensor
    return isinstance(tensor, _DTENSOR)


def local_part(tensor: Tensor) -> Tensor:
    """This rank's shard of a DTensor; any other tensor as it is."""
    return tensor.to_local() if is_sharded(tensor) else tensor


def full_tensor(tensor):
    """A DTensor (an FSDP2 shard) gathered whole on every rank (a
    collective); any other value as it is."""
    return tensor.full_tensor() if is_sharded(tensor) else tensor


def shard_like(value: Tensor, like):
    """``value`` (a whole tensor, the same on every rank) sharded as the
    DTensor ``like`` is, each rank keeping its own block without
    communication; as it is when ``like`` is not a DTensor."""
    if not is_sharded(like):
        return value
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(
        value.to(like.device, like.dtype),
        like.device_mesh,
        like.placements,
        src_data_rank=None,
    )


def plain_named_parameters(model: nn.Module) -> T.Dict[str, Tensor]:
    """The model's parameters that FSDP does not shard, by name: every
    parameter of a model without FSDP."""
    return {
        name: p for name, p in model.named_parameters() if not is_sharded(p)
    }


def replicate_state(state):
    """Broadcast the model's replicated parameters and buffers from rank
    0, so every rank starts from the same weights (JAX's ``device_put``
    onto a replicated sharding). Returns ``state``."""
    if rank_and_world()[1] == 1:
        return state
    with torch.no_grad():
        tensors = list(plain_named_parameters(state.model).values())
        tensors += list(state.model.buffers())
        for tensor in tensors:
            dist.broadcast(tensor.data, src=0)
    return state


def reduce_gradients(model: nn.Module) -> None:
    """Average the replicated parameters' gradients over the data group:
    one all-reduce of their flat fp32 concatenation, divided by the world
    size (a missing gradient counts as zeros), in any process group, one
    rank's included. FSDP's reduce-scatter has already averaged the
    sharded ones."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    world = rank_and_world()[1]
    params = list(plain_named_parameters(model).values())
    if not params:
        return
    grads = [
        torch.zeros_like(p) if p.grad is None else p.grad for p in params
    ]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= world
    offset = 0
    for p, g in zip(params, grads):
        p.grad = flat[offset : offset + g.numel()].view_as(g)
        offset += g.numel()


def fsdp_state_sharding(model: nn.Module, min_size: int = 2**16) -> T.List[str]:
    """The names of the submodules FSDP shards: each that owns a parameter
    of at least ``min_size`` elements (JAX's rule of which leaves shard)."""
    return [
        name
        for name, module in model.named_modules()
        if name
        and any(
            p.numel() >= min_size
            for p in module.parameters(recurse=False)
        )
    ]


def shard_state_fsdp(
    state,
    min_size: int = 2**16,
    compute_dtype: torch.dtype = torch.float32,
) -> T.List[str]:
    """Apply FSDP2 (``fully_shard``) over the default process group to the
    submodules
    of ``fsdp_state_sharding``, in place, before the optimizer is bound:
    the forward gathers their parameters in ``compute_dtype`` and the
    backward reduce-scatters and averages their gradients in fp32. Returns
    the names of the sharded submodules."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard

    model = state.model
    device_type = next(model.parameters()).device.type
    mesh = DeviceMesh.from_group(dist.group.WORLD, device_type)
    policy = MixedPrecisionPolicy(
        param_dtype=None if compute_dtype == torch.float32 else compute_dtype,
        reduce_dtype=torch.float32,
        cast_forward_inputs=False,
    )
    names = fsdp_state_sharding(model, min_size)
    modules = dict(model.named_modules())
    for name in reversed(names):  # submodules before their parents
        fully_shard(modules[name], mesh=mesh, mp_policy=policy)
    return names
