"""The U-TAE train cell (configuration ``utae-pastis``): ``fit``'s train
step over a PASTIS-shaped split resident on the card.

Set-up builds the model first (``train/fit.py::model_from_kwargs``; a
program without U-TAE fails here, before any data is made), then draws
the patches on the card (``traffic/pastis.py``), the per-band z-score of
their real dates, and the seeded weights; it puts the split in a
``DeviceChipCache`` (``from_arrays``: the patches never go through chip
files) and builds the optimizer and the step as ``fit`` does for "hbm"
(``make_train_step`` under "16-mixed", ``make_hbm_train_step``: one CUDA
graph replay a step from the third), and runs the first three steps
through the window's own loop. The window continues the same loop. After
it, the plain reference (``reference/utae.py``, fp32, TF32 off) replays
those three steps from the same weights, the same batches (the cache's
first epoch order, worked out again from the seed) and the program's
dropout masks (the same generator, seeded alike); the losses, the first
gradient and the parameters' change are compared as the other train cells
compare them (``drivers/train.py::readings``).

The model's widths come from the configuration's lists; its
``hidden_channels`` is the first of them. The patches are padded to
``time`` dates.

``control_readings`` gives the readings of the control (the reference in
fp8) and of three faults (half the batch, the state left unchanged, pad
dates left unmasked) against the reference;

    python3 -m portbench.drivers.train_utae --seeds 1,2,3 [--chips 64]

prints, a seed a line, the program's readings and those, on a card: the
numbers the cell's limits were set from (``--fp32``: the program in fp32
with TF32 off, which shows what its bf16 compute adds).
"""

import argparse
import contextlib
import json
import math
import shutil
import sys
import tempfile
import time
import typing as T
from pathlib import Path

import numpy as np
import torch

from portbench import compare
from portbench.drivers.train import readings
from portbench.roofline_utae import count_utae, reference_utae
from portbench.trace import layer
from portbench.traffic.pastis import pastis_patches

COMPARED_STEPS = 3
WARMUP_STEPS = 2  # after the compared ones
SCALE = 10000.0


def program_seed(seed: int) -> int:
    return seed % (2**31)


def model_kwargs(config) -> T.Tuple[int, T.Dict[str, T.Any]]:
    """(in_channels, the program's model keyword arguments)."""
    model = dict(config["model"])
    in_channels = int(model.pop("in_channels"))
    model["hidden_channels"] = model["encoder_widths"][0]
    return in_channels, model


def make_params(config, seed):
    """The ``fit`` configuration of the cell's train section."""
    from cultionet_tpu_torch.config import CultionetParams

    in_channels, model = model_kwargs(config)
    return CultionetParams(
        in_channels=in_channels, in_time=model["in_time"], model_type=model["model_type"],
        hidden_channels=model["hidden_channels"], **config["train"],
        use_chipstore="hbm", random_seed=program_seed(seed),
    )


@torch.no_grad()
def norm_stats(x: torch.Tensor, date_count: np.ndarray, chunk: int = 8):
    """Per-band mean and std of the patches' real dates (x / 10000), in
    fp64 on x's device, a few patches at a time."""
    steps, bands = x.shape[1], x.shape[-1]
    total = torch.zeros(bands, dtype=torch.float64, device=x.device)
    squares = torch.zeros_like(total)
    count = 0
    for i in range(0, x.shape[0], chunk):
        part = x[i: i + chunk].to(torch.float64) / SCALE
        real = torch.from_numpy(np.arange(steps)[None] < date_count[i: i + chunk, None])
        part = part[real.to(x.device)].reshape(-1, bands)
        total += part.sum(0)
        squares += (part * part).sum(0)
        count += part.shape[0]
    mean = total / count
    std = (squares / count - mean * mean).clamp_min(0).sqrt()
    return mean.float().cpu().numpy(), std.float().cpu().numpy()


@torch.no_grad()
def seeded_state(model: torch.nn.Module, seed: int) -> T.Dict[str, torch.Tensor]:
    """Every parameter of the reference ``model`` drawn from one generator
    on its device in one call, scaled by its kind: He-normal convolutions
    and linear layers over their fan-in, L-TAE's queries N(0, 2 / d_k) as
    published, norm scales near 1, small biases; running statistics 0 and
    1 (the comparison trains, and training normalizes with the batch's)."""
    device = next(model.parameters()).device
    modules = dict(model.named_modules())
    named = list(model.named_parameters())
    draw = torch.randn(
        sum(p.numel() for _, p in named),
        generator=torch.Generator(device=device).manual_seed(int(seed)), device=device,
    )
    norms = (torch.nn.GroupNorm, torch.nn.modules.batchnorm._BatchNorm)
    offset = 0
    for name, p in named:
        owner, _, leaf = name.rpartition(".")
        module = modules[owner]
        if leaf == "bias":
            std, mean = 0.1, 0.0
        elif isinstance(module, norms):
            std, mean = 0.02, 1.0
        elif leaf == "Q":
            std, mean = math.sqrt(2.0 / p.shape[1]), 0.0
        else:
            fan_in = (p.shape[0] if isinstance(module, torch.nn.ConvTranspose2d)
                      else p.shape[1]) * math.prod(p.shape[2:])
            std, mean = math.sqrt(2.0 / fan_in), 0.0
        p.copy_(draw[offset: offset + p.numel()].view(p.shape) * std + mean)
        offset += p.numel()
    for module in model.modules():
        if isinstance(module, torch.nn.modules.batchnorm._BatchNorm):
            module.reset_running_stats()
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def reference_model(config, device) -> torch.nn.Module:
    """The fp32 reference U-TAE on ``device``, built there (its date
    encoding's table is a buffer that ``to_empty`` would leave unset)."""
    with torch.device(device):
        return reference_utae(config["model"])


def epochs(loader):
    while True:
        yield from loader


def first_batches(data, seed: int, batch_size: int, steps: int):
    """The first ``steps`` batches of the cache's first epoch
    (``default_rng(seed).permutation(N)``), as (x int16 on the card, y,
    dates, date_count)."""
    order = np.random.default_rng(program_seed(seed)).permutation(data["x"].shape[0])
    out = []
    for i in range(steps):
        idx = order[i * batch_size: (i + 1) * batch_size]
        rows = torch.from_numpy(idx).to(data["x"].device)
        out.append((
            data["x"].index_select(0, rows).clone(),
            torch.from_numpy(data["y"][idx]),
            torch.from_numpy(data["dates"][idx]),
            torch.from_numpy(data["date_count"][idx]),
        ))
    return out


@contextlib.contextmanager
def no_tf32():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def replay(config, seed, batches, norm, state0, device, compute=None, fault=None):
    """The reference's first steps: losses, the first gradient's and the
    change's per-leaf norms. ``compute`` wraps its forward and backward
    (the controls: ``reference/lowp_train.py::fp8_train_compute``, fp8
    forward and backward; ``reference/lowp.py::fp8_compute``, the forward
    alone); ``fault`` is
    "half_batch" (the first half of each batch) or "unmasked" (every date
    taken as real)."""
    from portbench.reference.utae import UTAETrainer

    ref = reference_model(config, device)
    ref.load_state_dict(state0)
    train = config["train"]
    trainer = UTAETrainer(ref, float(train["learning_rate"]), float(train["eps"]),
                          compute=compute)
    generator = torch.Generator(device=device).manual_seed(program_seed(seed))
    mean, std = (torch.from_numpy(v).to(device) for v in norm)
    losses = []
    with no_tf32():
        for x, y, dates, count in batches:
            if fault == "half_batch":
                half = x.shape[0] // 2
                x, y, dates, count = x[:half], y[:half], dates[:half], count[:half]
            x = (x.to(torch.float32) * (1.0 / SCALE)).clamp(1e-9, 1.0)
            x = ((x - mean) / std).permute(0, 1, 4, 2, 3)
            pad = torch.arange(x.shape[1])[None] >= count.to(torch.int64)[:, None]
            losses.append(trainer.step(
                x, dates.to(device), None if fault == "unmasked" else pad.to(device),
                y.to(device), generator,
            ))
    first_grad = compare.leaf_norms(trainer.first_grads)
    change = compare.leaf_norms({n: p.detach() - state0[n] for n, p in ref.named_parameters()})
    return {"losses": losses, "first_grad": first_grad, "change": change}


def run(ctx) -> None:
    from cultionet_tpu_torch.data.device_cache import DeviceChipCache
    from cultionet_tpu_torch.models import create_model
    from cultionet_tpu_torch.train import fit as fit_module
    from cultionet_tpu_torch.train.optim import build_optimizer
    from cultionet_tpu_torch.train.step import (
        create_train_state, make_hbm_train_step, make_train_step,
    )
    from cultionet_tpu_torch.utils import profiling

    traffic, config, device = ctx.traffic, ctx.config, ctx.device
    in_channels, kwargs = model_kwargs(config)
    model = create_model(in_channels, **kwargs)
    params = make_params(config, ctx.seed)
    batch_size = int(params.batch_size)

    data = pastis_patches(traffic, ctx.seed, device)
    norm = norm_stats(data["x"], data["date_count"])
    ref = reference_model(config, device)
    state0 = seeded_state(ref, ctx.seed)
    del ref
    model.load_state_dict(state0)
    cache = DeviceChipCache.from_arrays(data, batch_size, seed=params.random_seed, device=device)
    state = create_train_state(model, build_optimizer(optimizer=params.optimizer), device=device)
    state.optimizer = fit_module._build_tx(params, max(1, len(cache))).init(
        state.model.parameters()
    )
    step = make_train_step(
        loss_name=params.loss_name, precision=params.compute_precision, device=device,
        norm_stats=norm,
    )
    hbm_step = make_hbm_train_step(step, device=device)

    def train_step(state, batch, generator):
        return hbm_step(state, cache.arrays, batch.indices, generator)

    generator = torch.Generator(device=device).manual_seed(params.random_seed)
    batches = epochs(cache)
    ctx.host_s = {"data_wait": 0.0, "step_host": 0.0}

    def one_step(timed: bool):
        nonlocal state
        t0 = time.perf_counter()
        with layer("data.next"):
            batch = next(batches)
        t1 = time.perf_counter()
        with layer("train.step"):
            state, logs = train_step(state, batch, generator)
        t2 = time.perf_counter()
        if timed:
            ctx.host_s["data_wait"] += t1 - t0
            ctx.host_s["step_host"] += t2 - t1
        return logs

    losses = []
    for i in range(COMPARED_STEPS):
        losses.append(one_step(False)["loss"])
        if i == 0:
            # Adam's first moment after one update is (1 - 0.9) g; a
            # parameter the optimizer never updated has none and reads 0.
            moments = state.optimizer.torch_optimizer.state
            first_grad = compare.leaf_norms(
                {
                    n: moments[p]["exp_avg"] if "exp_avg" in moments.get(p, {})
                    else torch.zeros((), device=p.device)
                    for n, p in state.model.named_parameters()
                },
                scale=1.0 / (1.0 - 0.9),
            )
    change = compare.leaf_norms({
        n: p.detach() - state0[n] for n, p in state.model.named_parameters()
    })
    losses = [float(v) for v in losses]
    for _ in range(WARMUP_STEPS):
        one_step(False)
    ctx.setup_done()

    counts0 = dict(profiling.COUNTS)
    start = time.perf_counter()
    while time.perf_counter() - start < ctx.seconds:
        one_step(True)
        ctx.units += 1
        ctx.tracer.step()
    ctx.sync()
    ctx.window_s = time.perf_counter() - start
    ctx.tracer.close()
    ctx.attempted = ctx.units
    ctx.metrics["train_chips_per_s"] = ctx.units * batch_size / ctx.window_s
    ctx.read_peak_memory()
    ctx.extra["date_images"] = profiling.COUNTS["utae_date_images"] - counts0["utae_date_images"]
    ctx.extra["pad_images"] = profiling.COUNTS["utae_pad_images"] - counts0["utae_pad_images"]
    size, steps = data["x"].shape[2], data["x"].shape[1]
    if ctx.trace:
        ctx.counts = count_utae(
            config["model"], batch_size, steps, size,
            real_images=batch_size * float(np.mean(data["date_count"])),
        )
    compared = first_batches(data, ctx.seed, batch_size, COMPARED_STEPS)
    del state, model, step, hbm_step, train_step, batches, cache, data
    if device.type == "cuda":
        torch.cuda.empty_cache()

    program = {"losses": losses, "first_grad": first_grad, "change": change}
    reference = replay(config, ctx.seed, compared, norm, state0, device)
    for name, value in readings(program, reference).items():
        ctx.check(name, value)
    moving = compare.moving_leaves(reference["first_grad"])
    for key, leaves in (("first_grad", None), ("change", moving)):
        gap, leaf = compare.worst_leaf_gap(program[key], reference[key], leaves)
        print(f"worst {key} leaf {leaf}: program {program[key][leaf]!r} "
              f"reference {reference[key][leaf]!r}", file=sys.stderr)
    if ctx.extra.get("keep_replay"):
        ctx.extra["replay"] = (compared, norm, state0, program, reference)


def control_readings(cell, config, seed, device, replayed=None) -> T.Dict[str, T.Dict[str, float]]:
    """Against the fp32 reference, the readings of the control (the
    reference trained in fp8; and, as ``control_forward``, with only its
    forward in fp8) and of the faults: half of each batch, pad dates taken
    as real, and the state left unchanged (no update: a change of 0); each
    with its losses. ``replayed`` is a run's kept replay; without it the data and the
    weights are made anew from the seed."""
    if replayed is None:
        traffic = cell["traffic_params"]
        _, kwargs = model_kwargs(config)
        data = pastis_patches(traffic, seed, device)
        norm = norm_stats(data["x"], data["date_count"])
        state0 = seeded_state(reference_model(config, device), seed)
        compared = first_batches(data, seed, int(config["train"]["batch_size"]), COMPARED_STEPS)
        del data
        want = replay(config, seed, compared, norm, state0, device)
    else:
        compared, norm, state0, _, want = replayed
    from portbench.reference.lowp import fp8_compute
    from portbench.reference.lowp_train import fp8_train_compute

    got = {
        "control": replay(config, seed, compared, norm, state0, device,
                          compute=fp8_train_compute),
        "control_forward": replay(config, seed, compared, norm, state0, device,
                                  compute=fp8_compute),
    }
    for fault in ("half_batch", "unmasked"):
        got[fault] = replay(config, seed, compared, norm, state0, device, fault=fault)
    out = {name: dict(readings(value, want), losses=value["losses"]) for name, value in got.items()}
    unchanged = dict(want, change={n: 0.0 for n in want["change"]})
    out["unchanged"] = readings(unchanged, want)
    return out


def main(argv=None) -> int:
    from portbench import harness
    from portbench.trace import Tracer

    parser = argparse.ArgumentParser(description="U-TAE cell: readings that set its limits.")
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--workload", default="train-utae-pastis")
    parser.add_argument("--chips", type=int, default=None,
                        help="patches to make (default: the cell's)")
    parser.add_argument("--control", action="store_true", help="also the control and faults")
    parser.add_argument("--fp32", action="store_true",
                        help="the program in fp32 with TF32 off (what bf16 adds to the gaps)")
    args = parser.parse_args(argv)
    harness.cache_environment(harness.ROOT)
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = harness.load_json(harness.ROOT / "portbench" / "workloads" / f"{args.workload}.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = harness.load_json(harness.ROOT / entry["file"])
    if args.chips:
        cell["traffic_params"] = dict(cell["traffic_params"], chips=args.chips)
    if args.fp32:
        config = dict(config, train=dict(config["train"], precision="32"))
    if not torch.cuda.is_available():
        print("train_utae: no CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda:0")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        workdir = Path(tempfile.mkdtemp(prefix="portbench-utae-"))
        ctx = harness.Context(
            cell_name=args.workload, cell=cell, config=config, seed=seed, seconds=0.0,
            trace=False, device=device, root=harness.ROOT, workdir=workdir,
            start=time.perf_counter(), tracer=Tracer(False, 1, 1, device),
            extra={"keep_replay": args.control},
        )
        try:
            with no_tf32() if args.fp32 else contextlib.nullcontext():
                run(ctx)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        out = {"program": {**{c.name: c.value for c in ctx.checks}, **ctx.readings}}
        if args.control:
            compared, _, _, program, want = ctx.extra["replay"]
            out["losses"] = {"program": program["losses"], "reference": want["losses"]}
            out.update(control_readings(cell, config, seed, device, ctx.extra["replay"]))
        del ctx
        torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
