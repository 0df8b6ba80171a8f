"""The TSViT train cell (configuration ``tsvit-pastis24``): ``fit``'s
train step over PASTIS24-shaped tiles resident on the card.

Set-up builds the model first (``models/cultionet.py::create_model``; a
program without TSViT fails here, before any data is made), then draws
the tiles on the card (``traffic/pastis.py`` at 24 x 24), the per-band
z-score of their real dates, and the seeded weights; it puts the split in
a ``DeviceChipCache`` (``from_arrays``) and builds the optimizer and the
step as ``fit`` does for "hbm" (``make_train_step`` under "16-mixed",
``make_hbm_train_step``: one CUDA graph replay a step from the third),
and runs the first three steps through the window's own loop. The window
continues the same loop. After it, the plain reference
(``reference/tsvit.py``, fp32, TF32 off) replays those three steps from
the same weights and the same batches (the cache's first epoch order,
worked out again from the seed); the losses, the first gradient and the
parameters' change are compared as the other train cells compare them
(``drivers/train.py::readings``).

The model is built for the traffic's tile (``chip_size``, the
configuration's ``img_res`` 24 in the cell), its ``hidden_channels`` is
its ``dim``; the tiles are padded to ``time`` dates.

``control_readings`` gives the readings of the control (the reference
trained in fp8, ``reference/lowp_train.py``) and of two faults (half the
batch, the state left unchanged) against the reference;

    python3 -m portbench.drivers.train_tsvit --seeds 1,2,3 [--control] [--fp32]

prints, a seed a line, the program's readings and those, on a card: the
numbers the cell's limits were set from (``--fp32``: the program in fp32
with TF32 off, which shows what its bf16 compute adds; its temporal
attention then runs on the plain version, as the kernels' fp32 plan has
no room for a sequence of 79 steps).
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

import torch

from portbench import compare
from portbench.drivers.train import readings
from portbench.drivers.train_utae import epochs, first_batches, norm_stats, program_seed
from portbench.reference.tsvit import no_tf32
from portbench.roofline_tsvit import count_tsvit, reference_tsvit
from portbench.trace import layer
from portbench.traffic.pastis import pastis_patches

COMPARED_STEPS = 3
WARMUP_STEPS = 2  # after the compared ones
SCALE = 10000.0


def model_section(config, traffic) -> T.Dict[str, T.Any]:
    """The configuration's model, built for the traffic's tile."""
    return dict(config["model"], img_res=int(traffic["chip_size"]))


def model_kwargs(config, traffic) -> T.Tuple[int, T.Dict[str, T.Any]]:
    """(in_channels, the program's model keyword arguments)."""
    model = model_section(config, traffic)
    in_channels = int(model.pop("in_channels"))
    model["hidden_channels"] = model["dim"]
    return in_channels, model


def make_params(config, traffic, seed):
    """The ``fit`` configuration of the cell's train section."""
    from cultionet_tpu_torch.config import CultionetParams

    in_channels, model = model_kwargs(config, traffic)
    return CultionetParams(
        in_channels=in_channels, in_time=model["in_time"], model_type=model["model_type"],
        hidden_channels=model["hidden_channels"], **config["train"],
        use_chipstore="hbm", random_seed=program_seed(seed),
    )


@torch.no_grad()
def seeded_state(model: torch.nn.Module, seed: int) -> T.Dict[str, torch.Tensor]:
    """Every parameter of the reference ``model`` drawn from one generator
    on its device in one call: linear weights N(0, 1 / fan-in), biases
    N(0, 0.02), LayerNorm scales N(1, 0.02), the class tokens and the
    position embedding N(0, 1) (their published ``randn``)."""
    device = next(model.parameters()).device
    named = list(model.named_parameters())
    draw = torch.randn(
        sum(p.numel() for _, p in named),
        generator=torch.Generator(device=device).manual_seed(int(seed)), device=device,
    )
    offset = 0
    for name, p in named:
        if name.endswith("bias"):
            std, mean = 0.02, 0.0
        elif p.dim() == 1:
            std, mean = 0.02, 1.0
        elif name.endswith("weight"):
            std, mean = 1.0 / math.sqrt(p.shape[1]), 0.0
        else:
            std, mean = 1.0, 0.0
        p.copy_(draw[offset: offset + p.numel()].view(p.shape) * std + mean)
        offset += p.numel()
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def reference_model(config, traffic, device) -> torch.nn.Module:
    with torch.device(device):
        return reference_tsvit(model_section(config, traffic))


def replay(config, traffic, seed, batches, norm, state0, device, compute=None, fault=None):
    """The reference's first steps: losses, the first gradient's and the
    change's per-leaf norms. ``compute`` wraps its forward and backward
    (the control, ``reference/lowp_train.py::fp8_train_compute``);
    ``fault`` "half_batch" trains on the first half of each batch."""
    from portbench.reference.tsvit import TSViTTrainer, cosine_lr, day_of_year

    ref = reference_model(config, traffic, device)
    ref.load_state_dict(state0)
    train = config["train"]
    steps_per_epoch = max(1, int(traffic["chips"]) // int(train["batch_size"]))
    trainer = TSViTTrainer(ref, cosine_lr(float(train["learning_rate"]), steps_per_epoch),
                           float(train["eps"]), float(train["weight_decay"]), compute=compute)
    mean, std = (torch.from_numpy(v).to(device) for v in norm)
    losses = []
    with no_tf32():
        for x, y, dates, count in batches:
            if fault == "half_batch":
                half = x.shape[0] // 2
                x, y, dates, count = x[:half], y[:half], dates[:half], count[:half]
            count = count.to(device)
            x = (x.to(torch.float32) * (1.0 / SCALE)).clamp(1e-9, 1.0)
            real = torch.arange(x.shape[1], device=device)[None] < count.long()[:, None]
            x = (x - mean) / std * real[:, :, None, None, None]
            losses.append(trainer.step(x, day_of_year(dates.to(device), count), y.to(device)))
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

    traffic, config, device = ctx.traffic, ctx.config, ctx.device
    in_channels, kwargs = model_kwargs(config, traffic)
    model = create_model(in_channels, **kwargs)
    params = make_params(config, traffic, ctx.seed)
    batch_size = int(params.batch_size)

    data = pastis_patches(traffic, ctx.seed, device)
    norm = norm_stats(data["x"], data["date_count"], chunk=256)
    ref = reference_model(config, traffic, device)
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
            state, logs = hbm_step(state, cache.arrays, batch.indices, generator)
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
    if ctx.trace:
        ctx.counts = count_tsvit(model_section(config, traffic), batch_size, data["x"].shape[1])
    compared = first_batches(data, ctx.seed, batch_size, COMPARED_STEPS)
    del state, model, step, hbm_step, batches, cache, data
    if device.type == "cuda":
        torch.cuda.empty_cache()

    program = {"losses": losses, "first_grad": first_grad, "change": change}
    reference = replay(config, traffic, ctx.seed, compared, norm, state0, device)
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
    reference trained in fp8) and of the faults: half of each batch, and
    the state left unchanged (no update: a change of 0); each with its
    losses. ``replayed`` is a run's kept replay; without it the data and
    the weights are made anew from the seed."""
    traffic = cell["traffic_params"]
    if replayed is None:
        data = pastis_patches(traffic, seed, device)
        norm = norm_stats(data["x"], data["date_count"], chunk=256)
        state0 = seeded_state(reference_model(config, traffic, device), seed)
        compared = first_batches(data, seed, int(config["train"]["batch_size"]), COMPARED_STEPS)
        del data
        want = replay(config, traffic, seed, compared, norm, state0, device)
    else:
        compared, norm, state0, _, want = replayed
    from portbench.reference.lowp_train import fp8_train_compute

    got = {
        "control": replay(config, traffic, seed, compared, norm, state0, device,
                          compute=fp8_train_compute),
        "half_batch": replay(config, traffic, seed, compared, norm, state0, device,
                             fault="half_batch"),
    }
    out = {name: dict(readings(value, want), losses=value["losses"]) for name, value in got.items()}
    unchanged = dict(want, change={n: 0.0 for n in want["change"]})
    out["unchanged"] = readings(unchanged, want)
    return out


def main(argv=None) -> int:
    from cultionet_tpu_torch.ops import flags
    from portbench import harness
    from portbench.trace import Tracer

    parser = argparse.ArgumentParser(description="TSViT cell: readings that set its limits.")
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--workload", default="train-tsvit-pastis24")
    parser.add_argument("--chips", type=int, default=None,
                        help="tiles to make (default: the cell's)")
    parser.add_argument("--control", action="store_true", help="also the control and faults")
    parser.add_argument("--fp32", action="store_true",
                        help="the program in fp32 with TF32 off (what bf16 adds to the gaps); its "
                             "temporal attention on the plain version, since the kernels' fp32 "
                             "plan has no room for 79 steps, and so eagerly")
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
        print("train_tsvit: no CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda:0")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        workdir = Path(tempfile.mkdtemp(prefix="portbench-tsvit-"))
        ctx = harness.Context(
            cell_name=args.workload, cell=cell, config=config, seed=seed, seconds=0.0,
            trace=False, device=device, root=harness.ROOT, workdir=workdir,
            start=time.perf_counter(), tracer=Tracer(False, 1, 1, device),
            extra={"keep_replay": args.control},
        )
        try:
            with no_tf32() if args.fp32 else contextlib.nullcontext():
                flags.set_cuda_temporal(not args.fp32)
                run(ctx)
        finally:
            flags.set_cuda_temporal(True)
            shutil.rmtree(workdir, ignore_errors=True)
        out = {"program": {**{c.name: c.value for c in ctx.checks}, **ctx.readings}}
        if args.control:
            _, _, _, program, want = ctx.extra["replay"]
            out["losses"] = {"program": program["losses"], "reference": want["losses"]}
            for name, value in control_readings(cell, config, seed, device,
                                                ctx.extra["replay"]).items():
                # The limits each fails, held as the harness holds a run's.
                checks = [harness.Check(k, value[k], v) for k, v in cell["limits"].items()]
                out[name] = dict(value, fails=[c.name for c in checks if not c.ok])
        del ctx
        torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
