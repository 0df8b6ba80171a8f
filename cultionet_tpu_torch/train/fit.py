"""The training loop (port of cultionet_tpu/train/fit.py::fit, for one
card).

``fit(params)`` splits the dataset into train and validation chips, loads
them in batches with background prefetch to the device, builds the
CLI-default optimizer (AdamW with the OneCycle learning rate and beta1
cycle, global-norm clip), resumes from the ``last`` checkpoint when there
is one, and runs epochs of training then validation. It writes
``history.csv`` (and, when asked, the per-batch validation metrics), keeps
``last`` every epoch and ``best`` by ``val_score``, averages the weights
over the last epochs when asked (stochastic weight averaging, then the
BatchNorm statistics re-estimated), and scores a test set into
``test.metrics``. Dropout draws only from a ``torch.Generator`` seeded with
``random_seed``. With ``augment_prob > 0`` the train split's chips go
through host augmentation (``augment/``) in the loader's thread; the
validation split never does. A user partition file
(``spatial_partitions`` with ``partition_name``) validates on the chips
inside the named polygons. ``auto_lr_find`` runs a learning-rate sweep
(``lr_finder.py``) instead of training; ``model_pruning`` zeroes the
smallest weights after the epochs (``prune.py``), before the weight
averaging, as the JAX loop does. ``pretrained_state`` with ``finetune``
is transfer learning (``model.py::fit_transfer``).

The device data path (``use_chipstore``) trains from raw int16 chips:
"stream" (or True) reads them from a chipstore file through the native
loader (``data/chipstore.py``), "hbm" keeps the whole train split on the
device and gathers each batch there (``data/device_cache.py``), and
"auto" takes "hbm" when the split fits half the device's memory. The train
step then dequantizes, clips, augments (``device_augment``,
``device_augment_noise``; these also apply on the host path) and
z-scores on the device; host augmenters do not run, and validation stays
on the host loader.

Every model option of the JAX configuration builds
(``model_from_kwargs``), ``remat`` included.

Data parallel (``parallel/``). JAX runs ``devices > 1`` as one program
over a mesh; PyTorch runs one process per device. ``fit`` with
``devices = N > 1`` and no process group launches N ranks itself
(``parallel/distributed.py::launch``: rank r on ``cuda:r`` over NCCL, or
on the CPU over gloo) and returns rank 0's result. Each rank draws the
same shuffled global batch order and trains on its contiguous block of
every batch through the sharded step, so the run computes the single
process's steps at the whole batch (dropout excepted: rank r's generator
is seeded ``random_seed + r``). ``fsdp`` shards the large parameters with
FSDP2 (``parallel/mesh.py::shard_state_fsdp``). In a group launched
outside ``fit`` (torchrun, ``initialize_distributed``) each process loads
the strided file stripe of ``process_local_selection`` and ``batch_size /
world`` chips a step, as JAX's multi-host loop does; ``steps_per_epoch``
must agree across them. Validation batches the group divides run
sharded, the others whole on every rank; the metrics are the global
batch's. Rank 0 alone writes checkpoints and ``history.csv``. The
learning-rate sweep runs in one process, as JAX's does.
"""

import csv
import dataclasses
import json
import logging
import typing as T
from pathlib import Path

import tempfile

import torch
import torch.distributed as dist
from torch.func import functional_call

from ..config import CultionetParams
from ..data.chipstore import ChipstoreLoader
from ..data.device_cache import DeviceChipCache, gather_batch
from ..data.loader import ChipLoader, process_local_selection
from ..models import CultioNet
from ..nn.dropout import dropout_rng
from ..parallel.distributed import assert_same_across_hosts, launch
from ..parallel.mesh import (
    data_parallel,
    full_tensor,
    plain_named_parameters,
    rank_and_world,
    replicate_state,
    shard_batch,
    shard_like,
    shard_state_fsdp,
)
from ..parallel.sharded import make_sharded_eval_step, make_sharded_train_step
from ..utils.device import resolve_device
from ..utils.profiling import span
from .checkpoint import Checkpointer
from .lr_finder import lr_find
from .optim import build_momentum_schedule, build_optimizer, build_schedule
from .precision import cast_floating, resolve_dtype
from .prune import l1_unstructured_prune
from .step import (
    TrainState,
    class_weights_from_counts,
    clip_unit,
    create_train_state,
    make_eval_step,
    make_hbm_train_step,
    make_train_step,
    model_inputs,
    norm_tensors,
    zscore,
)

logger = logging.getLogger(__name__)

FINAL_NAMES = ("final_a", "final_b", "final_c", "final_combine")


@dataclasses.dataclass
class FitResult:
    state: T.Optional[TrainState]
    model: CultioNet
    history: T.List[T.Dict[str, float]]
    best_score: float
    steps_per_epoch: int = 0


def model_from_kwargs(in_channels: int, kwargs: T.Mapping) -> CultioNet:
    """The port's CultioNet from the JAX model's keyword arguments
    (``CultionetParams.get_model_kwargs`` or a checkpoint's
    hyperparams)."""
    return CultioNet(in_channels=in_channels, **kwargs)


def build_model(params: CultionetParams) -> CultioNet:
    return model_from_kwargs(params.in_channels, params.get_model_kwargs())


def _append_csv(path: Path, row: T.Dict[str, T.Any]) -> None:
    """Append one row to a CSV file, writing the header when creating it."""
    path.parent.mkdir(parents=True, exist_ok=True)
    new = not path.exists()
    with open(path, "a", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=list(row))
        if new:
            writer.writeheader()
        writer.writerow(row)


def _append_batch_metrics(
    ckpt_dir: Path, rows: T.List[T.Dict[str, T.Any]]
) -> None:
    """Append an epoch's per-validation-batch rows to
    ``batch_metrics.parquet``, or to ``batch_metrics.csv`` where no parquet
    engine is installed."""
    if not rows:
        return
    try:
        import pandas as pd

        path = ckpt_dir / "batch_metrics.parquet"
        frame = pd.DataFrame(rows)
        if path.exists():
            frame = pd.concat([pd.read_parquet(path), frame])
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        frame.to_parquet(path)
    except (ImportError, OSError):
        for row in rows:
            _append_csv(ckpt_dir / "batch_metrics.csv", row)


def _mean_metrics(
    rows: T.List[T.Tuple[int, T.Dict[str, torch.Tensor]]]
) -> T.Dict[str, float]:
    """Batch-size weighted mean of metric dicts, in the JAX order."""
    total = sum(n for n, _ in rows)
    return {
        key: float(sum(n * float(m[key]) for n, m in rows) / max(total, 1))
        for key in rows[0][1]
    }


def _is_final(name: str) -> bool:
    return any(part in FINAL_NAMES for part in name.split("."))


def _trainable_mask(model: CultioNet, finetune: T.Optional[str]) -> T.List[bool]:
    """Per parameter (in ``model.parameters()`` order): 'all' trains
    everything; 'fc' or None only the final heads."""
    return [
        finetune == "all" or _is_final(name)
        for name, _ in model.named_parameters()
    ]


def _resolve_class_weights(params: CultionetParams):
    """(bg, fg) loss weights when ``scale_pos_weight`` is on: explicit
    ``class_counts`` first, else the NormValues pixel counts."""
    if not params.scale_pos_weight:
        return None
    crop = edge = None
    counts = params.class_counts
    if isinstance(counts, dict):
        crop, edge = counts.get("crop"), counts.get("edge")
    elif counts is not None:
        crop, edge = counts
    if crop is None or edge is None:
        nv = getattr(params.dataset, "norm_values", None)
        if nv is not None:
            crop = nv.dataset_crop_counts if crop is None else crop
            edge = nv.dataset_edge_counts if edge is None else edge
    if crop is None or edge is None:
        logger.warning(
            "scale_pos_weight=True but no class counts available "
            "(set class_counts or attach NormValues); proceeding unweighted"
        )
        return None
    return class_weights_from_counts(crop, edge)


def _schedule_steps(params: CultionetParams, steps_per_epoch: int) -> int:
    return max(1, steps_per_epoch // max(1, params.accumulate_grad_batches))


def _build_tx(params: CultionetParams, steps_per_epoch: int):
    steps = _schedule_steps(params, steps_per_epoch)
    return build_optimizer(
        optimizer=params.optimizer,
        learning_rate=build_schedule(
            params.lr_scheduler,
            learning_rate=params.learning_rate,
            epochs=params.epochs,
            steps_per_epoch=steps,
            steplr_step_size=params.steplr_step_size,
        ),
        weight_decay=params.weight_decay,
        eps=params.eps,
        gradient_clip_val=params.gradient_clip_val,
        gradient_clip_algorithm=params.gradient_clip_algorithm,
        accumulate_grad_batches=params.accumulate_grad_batches,
        # torch's OneCycleLR cycles beta1 opposite the learning rate.
        b1_schedule=build_momentum_schedule(
            params.lr_scheduler, params.epochs, steps
        )
        if params.optimizer == "AdamW"
        else None,
    )


@torch.no_grad()
def _reestimate_batch_stats(
    state: TrainState,
    loader,
    precision: str,
    device: torch.device,
    norm_stats=None,
) -> TrainState:
    """Recompute the BatchNorm running statistics under the current (SWA
    averaged) parameters: training-mode forward passes over the train
    loader in the compute type, outputs discarded, dropout drawn from a
    generator seeded 0 (the JAX pass's ``PRNGKey(0)``). With ``norm_stats``
    the loader's raw chips are dequantized, clipped and z-scored as the
    train step does, without augmentation. In a data-parallel run each rank
    passes its block of every batch and the statistics are the global
    batch's."""
    model = state.model.train()
    compute_dtype = resolve_dtype(precision)
    generator = torch.Generator(device=device).manual_seed(0)
    run_params = cast_floating(plain_named_parameters(model), compute_dtype)
    norm = norm_tensors(norm_stats, device)
    with dropout_rng(generator), data_parallel():
        for batch in loader:
            batch = batch.to(device).dequantize()
            if norm is not None:
                batch = zscore(clip_unit(batch), norm)
            functional_call(
                model, run_params, model_inputs(batch, compute_dtype)
            )
    return state


def _device_data_loader(
    params: CultionetParams,
    train_ds,
    device,
    batch_size: int,
    allow_hbm: bool = True,
    shard: T.Optional[T.Tuple[int, int]] = None,
    process_index: int = 0,
):
    """The train loader of ``use_chipstore`` and the in-step
    normalization statistics: a ``DeviceChipCache`` under "hbm" (and
    under "auto" when the split fits), else a ``ChipstoreLoader`` whose
    store goes beside the checkpoint (or under the dataset's ``cache/``).
    Ranks launched by ``fit`` (``shard=(rank, world)``) share one store,
    which rank 0 builds while the others wait, and each streams only its
    block of every batch; a resident split is whole on every rank, whose
    step gathers its block of the indices.

    Raises ``ValueError`` for ``log_transform`` (the step does not apply
    it) and for ``use_latlon`` with a resident split (its gather carries no
    coordinates; the JAX package fails at its first step). Without
    ``allow_hbm`` (a process of an externally launched group, which holds
    a file stripe) "hbm" and "auto" stream, with JAX's warning."""
    mode = params.use_chipstore
    if train_ds.log_transform:
        raise ValueError("use_chipstore does not support log_transform")
    if params.augment_prob > 0 and not params.device_augment:
        logger.warning(
            "use_chipstore skips host augmenters; set "
            "device_augment=True for in-step augmentation"
        )
    norm_stats = None
    if train_ds.norm_values is not None:
        nv = train_ds.norm_values
        norm_stats = (nv.dataset_mean, nv.dataset_std)
    if mode in ("hbm", "auto") and not allow_hbm:
        logger.warning(
            "use_chipstore='hbm' is single-host only (each process "
            "holds a file stripe); falling back to streaming"
        )
        mode = "stream"
    if mode == "hbm" or (
        mode == "auto" and DeviceChipCache.fits(train_ds, device=device)
    ):
        if params.use_latlon:
            raise ValueError(
                f"use_chipstore={mode!r} trains from a device-resident "
                "split, whose batches carry no lat/lon; use_latlon needs "
                "use_chipstore='stream'"
            )
        cache = DeviceChipCache(
            train_ds,
            batch_size=batch_size,
            seed=params.random_seed,
            device=device,
        )
        logger.info(
            f"device-resident dataset: {cache.num_chips} chips, "
            f"{cache.resident_bytes / 1e6:.0f} MB on {device}"
        )
        return cache, norm_stats
    cache_dir = (
        Path(params.ckpt_file).parent
        if params.ckpt_file is not None
        else Path(train_ds.root) / "cache"
    )
    builds = shard is None or shard[0] == 0
    if not builds:
        dist.barrier()  # rank 0 builds the store
    loader = ChipstoreLoader(
        train_ds,
        batch_size=batch_size,
        cache_path=cache_dir / "train.cts",
        seed=params.random_seed,
        num_threads=max(2, params.load_batch_workers),
        device=device,
        shard=shard,
        process_index=process_index,
    )
    if shard is not None and builds:
        dist.barrier()
    return loader, norm_stats


def _load_pretrained(
    model: CultioNet,
    pretrained_state: T.Union[TrainState, T.Mapping[str, torch.Tensor]],
    finetune: T.Optional[str],
) -> None:
    """Load pretrained parameters and buffers into ``model``; with
    ``finetune=None`` the parameters of its final heads keep their fresh
    initialization (the BatchNorm statistics are all pretrained, as in the
    JAX loop)."""
    if isinstance(pretrained_state, TrainState):
        pretrained_state = pretrained_state.model.state_dict()
    fresh = dict(model.named_parameters())
    merged = {
        name: fresh[name].detach()
        if finetune is None and name in fresh and _is_final(name)
        else value
        for name, value in pretrained_state.items()
    }
    model.load_state_dict(merged, strict=True)


def fit(
    params: CultionetParams,
    pretrained_state: T.Optional[
        T.Union[TrainState, T.Mapping[str, torch.Tensor]]
    ] = None,
    device="cuda",
) -> FitResult:
    """Train CultioNet from a CultionetParams configuration on ``device``.

    ``pretrained_state`` (a ``TrainState`` or a state dict of the same
    model, for transfer learning) seeds the parameters and BatchNorm
    statistics, and ``params.finetune`` chooses which parameters train:
    'all', or else only the final heads (which ``finetune=None`` also
    re-initializes). With ``params.devices > 1`` and no process group,
    ``fit`` launches that many ranks (``cuda:0..N-1``, or CPU processes
    for ``device="cpu"``) and returns rank 0's result.
    """
    device = resolve_device(device)
    params.check_checkpoint()

    dataset = params.dataset
    if params.in_channels is None:
        params.update_channels(dataset)

    if params.auto_lr_find:
        # A learning-rate sweep instead of training, in this process.
        sweep = lr_find(params, device=device)
        return FitResult(
            state=None,
            model=build_model(params),
            history=[
                {"lr": lr, "loss": loss}
                for lr, loss in zip(sweep.lrs, sweep.losses)
            ],
            best_score=(
                sweep.suggestion if sweep.suggestion is not None else -1.0
            ),
        )

    grouped = dist.is_available() and dist.is_initialized()
    if params.devices > 1 and not grouped:
        if params.batch_size % params.devices:
            raise ValueError(
                f"batch_size {params.batch_size} must divide evenly over "
                f"{params.devices} devices"
            )
        return _launch_fit(params, pretrained_state, device)
    return _fit_rank(params, pretrained_state, device, launched=False)


def _launch_fit(params: CultionetParams, pretrained_state, device) -> FitResult:
    """Run ``fit`` on ``params.devices`` ranks launched here; rank 0 hands
    back its model, optimizer state and history through a file."""
    if isinstance(pretrained_state, TrainState):
        pretrained_state = pretrained_state.model.state_dict()
    if pretrained_state is not None:
        pretrained_state = {
            n: t.detach().cpu() for n, t in pretrained_state.items()
        }
    # The checkpoint was already reset here; the ranks must not do it again.
    rank_params = dataclasses.replace(params, reset_model=False)
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "rank0.pt"
        launch(
            _fit_launched_rank,
            params.devices,
            device,
            args=(rank_params, pretrained_state, str(out)),
        )
        payload = torch.load(out, map_location="cpu", weights_only=False)
    model = build_model(params)
    state = create_train_state(
        model, build_optimizer(optimizer=params.optimizer), device=device
    )
    model.load_state_dict(payload["state"]["model"], strict=True)
    tx = _build_tx(params, payload["steps_per_epoch"])
    trainable = (
        None
        if pretrained_state is None
        else _trainable_mask(model, params.finetune)
    )
    state.optimizer = tx.init(model.parameters(), trainable)
    state.optimizer.load_state_dict(payload["state"]["optimizer"])
    state.step = payload["state"]["step"]
    return FitResult(
        state=state,
        model=model,
        history=payload["history"],
        best_score=payload["best_score"],
        steps_per_epoch=payload["steps_per_epoch"],
    )


def _fit_launched_rank(device, params, pretrained_state, out: str) -> None:
    """One rank of ``_launch_fit``, inside its process group."""
    result = _fit_rank(params, pretrained_state, device, launched=True)
    # Collectives (FSDP's shards gathered whole): every rank calls them.
    state = {
        "model": {
            n: full_tensor(t).detach().cpu()
            for n, t in result.state.model.state_dict().items()
        },
        "optimizer": result.state.optimizer.state_dict(),
        "step": result.state.step,
    }
    if rank_and_world()[0] == 0:
        torch.save(
            {
                "state": state,
                "history": result.history,
                "best_score": result.best_score,
                "steps_per_epoch": result.steps_per_epoch,
            },
            out,
        )


def _fit_rank(
    params: CultionetParams,
    pretrained_state,
    device: torch.device,
    launched: bool,
) -> FitResult:
    """The training loop of one process: the only one, a rank ``fit``
    launched (``launched``: it trains on its block of each global batch),
    or a process of a group launched outside (its file stripe)."""
    dataset = params.dataset
    rank, world = rank_and_world()
    grouped = dist.is_available() and dist.is_initialized()
    striped = grouped and world > 1 and not launched
    lead = rank == 0

    partition_file = params.spatial_partitions
    if partition_file and partition_file != "spatial" and params.partition_name:
        # User partition polygons: validate on the named partition. A
        # missing file raises (JAX falls back to a spatial split).
        if not Path(partition_file).exists():
            raise FileNotFoundError(
                f"spatial_partitions file {partition_file} does not exist"
            )
        train_ds, val_ds = dataset.split_by_partition(
            partition_file,
            params.partition_name,
            partition_column=params.partition_column,
        )
    else:
        train_ds, val_ds = dataset.split_train_val(
            val_frac=params.val_frac,
            spatial_balance=params.spatial_partitions is not None,
        )
    train_ds.augment_prob = params.augment_prob

    loader_batch_size = params.batch_size
    if striped:
        # JAX's multi-host rule: a disjoint stripe of the train files and
        # batch_size / world chips a step on each process.
        if params.batch_size % world:
            raise ValueError(
                f"global batch_size {params.batch_size} must divide over "
                f"{world} processes"
            )
        loader_batch_size = params.batch_size // world
        train_ds = train_ds.index_select(
            process_local_selection(len(train_ds), rank, world)
        )
    # A rank launched by ``fit`` takes its block of each global batch.
    blocks = launched and world > 1

    norm_stats = None
    if params.use_chipstore:
        train_loader, norm_stats = _device_data_loader(
            params, train_ds, device, loader_batch_size,
            allow_hbm=not striped,
            shard=(rank, world) if blocks else None,
            process_index=rank if striped else 0,
        )
    else:
        train_loader = ChipLoader(
            train_ds,
            batch_size=loader_batch_size,
            shuffle=True,
            drop_last=True,
            device=device,
            shard=(rank, world) if blocks else None,
        )
    hbm_cache = (
        train_loader if isinstance(train_loader, DeviceChipCache) else None
    )
    val_loader = ChipLoader(val_ds, batch_size=params.batch_size, device=device)
    steps_per_epoch = max(1, len(train_loader))
    if striped:
        assert_same_across_hosts(
            len(train_ds) // max(1, loader_batch_size), "steps_per_epoch"
        )

    model = build_model(params)
    # Placeholder optimizer: the real one is bound once the trainable mask
    # is known.
    state = create_train_state(
        model,
        build_optimizer(optimizer=params.optimizer),
        seed=params.random_seed,
        device=device,
    )
    trainable = None
    if pretrained_state is not None:
        _load_pretrained(state.model, pretrained_state, params.finetune)
        trainable = _trainable_mask(state.model, params.finetune)
    if world > 1:
        replicate_state(state)
        if params.fsdp:
            shard_state_fsdp(
                state,
                min_size=params.fsdp_min_size,
                compute_dtype=resolve_dtype(params.compute_precision),
            )
    tx = _build_tx(params, steps_per_epoch)
    state.optimizer = tx.init(state.model.parameters(), trainable)

    lr_schedule = build_schedule(
        params.lr_scheduler,
        learning_rate=params.learning_rate,
        epochs=params.epochs,
        steps_per_epoch=_schedule_steps(params, steps_per_epoch),
        steplr_step_size=params.steplr_step_size,
    )
    generator = torch.Generator(device=device).manual_seed(
        params.random_seed + rank
    )

    ckpt = None
    start_epoch = 0
    hyperparams = {
        **{
            k: (list(v) if isinstance(v, (list, tuple)) else v)
            for k, v in params.get_model_kwargs().items()
        },
        "in_channels": params.in_channels,
        "edge_class": params.edge_class,
        "loss_name": str(params.loss_name),
        # Data-pipeline flags that serving must reproduce.
        "log_transform": bool(train_ds.log_transform),
        "normalized_input": train_ds.norm_values is not None,
    }
    if params.ckpt_file is not None:
        ckpt_file = Path(params.ckpt_file)
        ckpt = Checkpointer(ckpt_file.parent / f"{ckpt_file.stem}_store")
        if ckpt.has_last():
            meta = ckpt.load_meta("last")
            state = ckpt.restore(state, "last", generator=generator)
            start_epoch = meta["epoch"] + 1
            # Replay the shuffles of the finished epochs, so the resumed
            # epochs see the batches an uninterrupted run would.
            train_loader.skip_epochs(start_epoch)
            if lead:
                logger.info(f"Resumed from epoch {meta['epoch']}")

    class_weights = _resolve_class_weights(params)
    step_kwargs = dict(
        loss_name=params.loss_name,
        edge_class=params.edge_class,
        precision=params.compute_precision,
        class_weights=class_weights,
        device=device,
    )
    train_kwargs = dict(
        step_kwargs,
        device_augment=params.device_augment,
        device_augment_noise=params.device_augment_noise,
        norm_stats=norm_stats,
    )
    # In a process group every step goes through the sharded steps (at
    # world size 1 they are the plain steps and one all-reduce).
    eval_step = make_eval_step(**step_kwargs)
    sharded_eval_step = (
        make_sharded_eval_step(**step_kwargs) if grouped else eval_step
    )
    step = (
        make_sharded_train_step(**train_kwargs)
        if grouped
        else make_train_step(**train_kwargs)
    )

    def local_block(batch):
        return shard_batch(batch) if blocks else batch

    if hbm_cache is not None:
        hbm_step = make_hbm_train_step(step, device=device)

        def train_step(state, batch, generator):
            indices = local_block(batch).indices
            return hbm_step(state, hbm_cache.arrays, indices, generator)

    else:  # the loaders already deliver this rank's block
        train_step = step

    def evaluate(batch):
        """A validation batch: sharded where the group divides it, else
        whole on every rank (JAX's unsharded fallback)."""
        if world > 1 and batch.num_samples % world == 0:
            return sharded_eval_step(state, shard_batch(batch))
        return eval_step(state, batch)

    history: T.List[T.Dict[str, float]] = []
    best_score = float("inf")
    if ckpt is not None and ckpt.has_best():
        best_score = ckpt.load_meta("best")["metrics"].get(
            "val_score", float("inf")
        )
    if params.skip_train:
        return FitResult(
            state=state, model=model, history=history, best_score=best_score,
            steps_per_epoch=steps_per_epoch,
        )

    swa_params = None
    swa_count = 0
    swa_start_epoch = int(
        params.epochs * params.stochastic_weight_averaging_start
    )
    for epoch in range(start_epoch, params.epochs):
        train_rows = []
        batches = iter(train_loader)
        while True:
            with span("fit.data_wait"):
                batch = next(batches, None)
            if batch is None:
                break
            state, logs = train_step(state, batch, generator)
            train_rows.append((params.batch_size, logs))

        val_rows = []
        batch_metric_rows = []
        with span("fit.validate"):
            for batch_idx, batch in enumerate(val_loader):
                val_rows.append((batch.num_samples, evaluate(batch)))
                if params.save_batch_val_metrics and params.ckpt_file is not None:
                    batch_metric_rows.append(
                        {
                            "epoch": epoch,
                            "batch": batch_idx,
                            "num_samples": batch.num_samples,
                            **{k: float(v) for k, v in val_rows[-1][1].items()},
                        }
                    )
        if batch_metric_rows and lead:
            _append_batch_metrics(
                Path(params.ckpt_file).parent, batch_metric_rows
            )

        train_metrics = _mean_metrics(train_rows)
        val_metrics = _mean_metrics(val_rows)
        row = {
            "epoch": epoch,
            "loss": train_metrics["loss"],
            "val_loss": val_metrics["loss"],
            "val_score": val_metrics["score"],
            "vef1": val_metrics["edge_f1"],
            "vcf1": val_metrics["crop_f1"],
            "vmae": val_metrics["dist_mae"],
            "lr_sch": float(
                lr_schedule(
                    (epoch + 1)
                    * steps_per_epoch
                    // max(1, params.accumulate_grad_batches)
                )
            ),
        }
        history.append(row)
        if params.ckpt_file is not None and lead:
            _append_csv(Path(params.ckpt_file).parent / "history.csv", row)
        if lead:
            logger.info(
                f"epoch {epoch}: loss={row['loss']:.4f} "
                f"val_loss={row['val_loss']:.4f} "
                f"val_score={row['val_score']:.4f}"
            )

        if params.stochastic_weight_averaging and epoch >= swa_start_epoch:
            current = {
                n: p.detach().float() for n, p in state.model.named_parameters()
            }
            if swa_params is None:
                swa_params = {n: p.clone() for n, p in current.items()}
                swa_count = 1
            else:
                swa_count += 1
                for n, avg in swa_params.items():
                    avg += (current[n] - avg) / swa_count

        if ckpt is not None:
            with span("fit.save"):
                ckpt.save_last(
                    state, epoch, metrics=row, hyperparams=hyperparams,
                    generator=generator,
                )
                if row["val_score"] < best_score:
                    best_score = row["val_score"]
                    ckpt.save_best(
                        state, epoch, metrics=row, hyperparams=hyperparams,
                        generator=generator,
                    )

    if params.model_pruning:
        # The magnitude threshold is global: FSDP's shards gathered whole.
        pruned = l1_unstructured_prune(
            {
                n: full_tensor(p.detach()).float()
                for n, p in state.model.named_parameters()
            }
        )
        with torch.no_grad():
            for n, p in state.model.named_parameters():
                p.copy_(shard_like(pruned[n], p))

    if swa_params is not None:
        with torch.no_grad():
            for n, p in state.model.named_parameters():
                p.copy_(swa_params[n])
        if hbm_cache is not None:
            # Real batches of the resident split's next epoch.
            refit_batches = (
                gather_batch(
                    hbm_cache.arrays, local_block(b).indices.to(device)
                )
                for b in hbm_cache
            )
        else:  # the loaders already deliver this rank's block
            refit_batches = train_loader
        state = _reestimate_batch_stats(
            state,
            refit_batches,
            params.compute_precision,
            device,
            norm_stats=norm_stats,
        )
        if ckpt is not None:
            ckpt.save_last(
                state, params.epochs - 1, metrics={"swa": 1.0},
                hyperparams=hyperparams, generator=generator,
            )

    if params.test_dataset is not None and params.ckpt_file is not None:
        test_loader = ChipLoader(
            params.test_dataset, batch_size=params.batch_size, device=device
        )
        test_rows = [(b.num_samples, evaluate(b)) for b in test_loader]
        if lead:
            out_path = Path(params.ckpt_file).parent / "test.metrics"
            out_path.write_text(json.dumps(_mean_metrics(test_rows), indent=2))

    return FitResult(
        state=state, model=model, history=history, best_score=best_score,
        steps_per_epoch=steps_per_epoch,
    )
