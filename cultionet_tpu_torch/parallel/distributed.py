"""Process-group initialization and topology helpers (port of
cultionet_tpu/parallel/distributed.py).

JAX runs one program over every device of a host and joins hosts through
``jax.distributed.initialize``; PyTorch runs one process per card and
joins them in a ``torch.distributed`` process group. Call
``initialize_distributed()`` once per process before training: with its
arguments, or under ``torchrun``, which sets ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` (``env://``). A card's group
talks over NCCL, a CPU group over gloo. ``train/fit.py`` then follows the
JAX multi-host rule (each process loads its own file stripe).
"""

import os
import socket
import typing as T

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def initialize_distributed(
    coordinator_address: T.Optional[str] = None,
    num_processes: T.Optional[int] = None,
    process_id: T.Optional[int] = None,
    device: T.Union[str, torch.device] = "cuda",
) -> None:
    """``init_process_group`` for one process per device: NCCL for a CUDA
    ``device`` (the process's card, ``cuda:<LOCAL_RANK>`` as torchrun sets
    it, else ``cuda:<rank>``, is made current here), gloo for the CPU.
    ``coordinator_address`` is ``host:port`` of rank 0; without it the
    group reads torchrun's environment (``env://``)."""
    device = torch.device(device)
    kwargs = {}
    if coordinator_address is not None:
        kwargs["init_method"] = f"tcp://{coordinator_address}"
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend=backend, **kwargs)
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())


def topology_summary() -> dict:
    """The JAX keys, for a group of one device per process."""
    if not (dist.is_available() and dist.is_initialized()):
        rank, world, backend = 0, 1, None
    else:
        rank, world = dist.get_rank(), dist.get_world_size()
        backend = dist.get_backend()
    on_card = backend == "nccl" or (
        backend is None and torch.cuda.is_available()
    )
    return {
        "process_index": rank,
        "process_count": world,
        "global_device_count": world,
        "local_device_count": 1,
        "platform": "gpu" if on_card else "cpu",
    }


def assert_same_across_hosts(value: int, name: str = "value") -> None:
    """Raise ``ValueError`` unless every process of the group holds the
    same ``value`` (for example ``steps_per_epoch``, which keeps the ranks'
    epoch loops in lockstep)."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, int(value))
    if len(set(gathered)) != 1:
        raise ValueError(f"{name} differs across hosts: {gathered}")


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _rank_main(rank, fn, world, port, device_type, threads, args):
    torch.set_num_threads(threads)
    if device_type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    dist.init_process_group(
        backend="nccl" if device_type == "cuda" else "gloo",
        init_method=f"tcp://127.0.0.1:{port}",
        world_size=world,
        rank=rank,
    )
    try:
        fn(device, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def launch(
    fn: T.Callable,
    nprocs: int,
    device: T.Union[str, torch.device],
    args: T.Sequence = (),
) -> None:
    """Run ``fn(rank_device, *args)`` on ``nprocs`` new processes joined in
    one process group, and wait for all of them (one failing ends the
    others, and its error is raised here). ``fn`` must be importable by
    name (a module-level function). On a CUDA ``device`` rank r takes
    ``cuda:r`` over NCCL, which needs ``nprocs`` cards. On the CPU the
    ranks talk over gloo and split this process's threads."""
    device = torch.device(device)
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        if cards < nprocs:
            raise RuntimeError(
                f"{nprocs} ranks over NCCL need {nprocs} cards; this "
                f"machine has {cards}"
            )
    threads = max(1, torch.get_num_threads() // nprocs)
    mp.start_processes(
        _rank_main,
        args=(fn, nprocs, free_port(), device.type, threads, tuple(args)),
        nprocs=nprocs,
        join=True,
        start_method="spawn",
    )
