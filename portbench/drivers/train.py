"""Train cells: the ``fit`` loop's train steps, built as
``train/fit.py::_fit_rank`` builds them, over 512 field-layout chips.

Traffic ``mode``: "hbm" trains from the split resident on the card
(``_device_data_loader``, ``make_hbm_train_step``, in-step dihedral
augmentation); "files" reads ``.npz`` chips through ``ChipLoader`` and
``ChipDataset`` with host augmentation. Set-up writes the chips, builds
the loader, the model with the benchmark's weights, the optimizer and the
step, and runs the first three steps through the window's own loop; the
window then continues the same loop. After it, the reference replays the
three steps from the same weights, chips and seeds, and the losses, the
first gradient and the parameters' change after three steps are compared.
"""

import sys
import time
import typing as T

import numpy as np
import torch

from portbench import compare
from portbench.reference.step import ReferenceTrainer, device_batch, host_chip
from portbench.roofline import count_model
from portbench.trace import layer
from portbench.traffic.fields import field_chips
from portbench.weights import reference_model, seeded_state

COMPARED_STEPS = 3
WARMUP_STEPS = 2  # after the compared ones


def program_seed(seed: int) -> int:
    return seed % (2**31)


def norm_stats(x: np.ndarray) -> T.Tuple[np.ndarray, np.ndarray]:
    """Per-band mean and std of the chips' reflectance (the z-score the
    training pipeline applies), computed in float64."""
    flat = x.reshape(-1, x.shape[-1]).astype(np.float64) / 10000.0
    return flat.mean(0).astype(np.float32), flat.std(0).astype(np.float32)


def write_chips(data: T.Mapping[str, np.ndarray], directory) -> list:
    """One uncompressed ``.npz`` chip a file, in the chip layout the
    program reads (x (1, T, H, W, C), y and bdist (1, H, W))."""
    directory.mkdir(parents=True, exist_ok=True)
    files = []
    for i in range(data["x"].shape[0]):
        path = directory / f"data_{i:05d}.npz"
        np.savez(path, x=data["x"][i: i + 1], y=data["y"][i: i + 1],
                 bdist=data["bdist"][i: i + 1])
        files.append(path)
    return files


def calibration_input(data, norm, device) -> torch.Tensor:
    x = torch.from_numpy(data["x"][:2]).to(device).float() / 10000.0
    x = x.clamp(1e-9, 1.0)
    return (x - torch.from_numpy(norm[0]).to(device)) / torch.from_numpy(norm[1]).to(device)


def make_params(config, traffic, seed, dataset):
    from cultionet_tpu_torch.config import CultionetParams

    model = dict(config["model"])
    return CultionetParams(
        dataset=dataset,
        in_channels=model.pop("in_channels"),
        in_time=model.pop("in_time"),
        **model,
        **config["train"],
        augment_prob=traffic["augment_prob"],
        use_chipstore="hbm" if traffic["mode"] == "hbm" else False,
        device_augment=traffic["mode"] == "hbm",
        random_seed=program_seed(seed),
    )


def epochs(loader):
    """The loader's batches, epoch after epoch (each pass draws its own
    order, as ``fit``'s epochs do)."""
    while True:
        yield from loader


def run(ctx) -> None:
    from cultionet_tpu_torch.data.datasets import ChipDataset
    from cultionet_tpu_torch.data.loader import ChipLoader
    from cultionet_tpu_torch.train import fit as fit_module
    from cultionet_tpu_torch.train.optim import build_optimizer
    from cultionet_tpu_torch.train.step import (
        create_train_state, make_hbm_train_step, make_train_step,
    )
    from cultionet_tpu_torch.utils.normalize import NormValues

    traffic, config, device = ctx.traffic, ctx.config, ctx.device
    batch_size = int(config["train"]["batch_size"])
    data = field_chips(traffic, ctx.seed, device)
    norm = norm_stats(data["x"])
    files = write_chips(data, ctx.workdir / "chips")

    ref = reference_model(config, device)
    state0 = seeded_state(ref, ctx.seed, calibration_input(data, norm, device))
    del ref
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    nv = NormValues(norm[0], norm[1], np.zeros(2), np.zeros(2), len(norm[0]))
    dataset = ChipDataset(
        ctx.workdir / "chips", files=files, norm_values=nv,
        augment_prob=traffic["augment_prob"], random_seed=program_seed(ctx.seed),
    )
    params = make_params(config, traffic, ctx.seed, dataset)
    if traffic["mode"] == "hbm":
        loader, stats = fit_module._device_data_loader(params, dataset, device, batch_size)
    else:
        loader, stats = ChipLoader(
            dataset, batch_size=batch_size, shuffle=True, drop_last=True,
            device=device,
        ), None
    model = fit_module.build_model(params)
    model.load_state_dict(state0)
    state = create_train_state(
        model, build_optimizer(optimizer=params.optimizer), device=device
    )
    steps_per_epoch = max(1, len(loader))
    tx = fit_module._build_tx(params, steps_per_epoch)
    state.optimizer = tx.init(state.model.parameters())
    step = make_train_step(
        loss_name=params.loss_name, edge_class=params.edge_class,
        precision=params.compute_precision, device=device,
        device_augment=params.device_augment,
        device_augment_noise=params.device_augment_noise, norm_stats=stats,
    )
    if traffic["mode"] == "hbm":
        hbm_step = make_hbm_train_step(step, device=device)

        def train_step(state, batch, generator):
            return hbm_step(state, loader.arrays, batch.indices, generator)
    else:
        train_step = step
    generator = torch.Generator(device=device).manual_seed(params.random_seed)
    batches = epochs(loader)
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
        logs = one_step(False)
        losses.append(logs["loss"])
        if i == 0:
            b1 = state.optimizer.spec.b1_schedule(0)
            moments = state.optimizer.torch_optimizer.state
            # A parameter the optimizer never updated has no moment: its
            # gradient, as the optimizer got it, reads 0.
            first_grad = compare.leaf_norms(
                {
                    n: moments[p]["exp_avg"] if "exp_avg" in moments.get(p, {})
                    else torch.zeros((), device=p.device)
                    for n, p in state.model.named_parameters()
                },
                scale=1.0 / (1.0 - b1),
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
        ctx.counts = count_model(
            config["model"], (batch_size, *data["x"].shape[1:]), backward=True
        )
    del state, loader, batches, model, step, train_step
    if device.type == "cuda":
        torch.cuda.empty_cache()

    program = {"losses": losses, "first_grad": first_grad, "change": change}
    reference = replay(ctx.config, traffic, ctx.seed, data, norm, state0, device)
    record_checks(ctx, program, reference)


def first_batches(traffic, seed, data, norm, device, batch_size, steps):
    """The first ``steps`` batches as the window's loader delivers them,
    worked out again from the seed: the epoch order, and in the "files"
    mode each chip's host pipeline with the dataset's generator."""
    rs = program_seed(seed)
    n = data["x"].shape[0]
    if traffic["mode"] == "hbm":
        # DeviceChipCache: epoch 0 draws default_rng(seed + 0).permutation(N).
        order = np.random.default_rng(rs).permutation(n)
        return [("device", order[i * batch_size: (i + 1) * batch_size]) for i in range(steps)]
    order = np.random.default_rng(rs).permutation(n)  # ChipLoader's shuffle
    rng = np.random.default_rng(rs)  # ChipDataset's generator
    out = []
    for i in range(steps):
        chips = [
            host_chip(data["x"][j], data["y"][j], data["bdist"][j], rng,
                      float(traffic["augment_prob"]), norm)
            for j in order[i * batch_size: (i + 1) * batch_size]
        ]
        out.append(("host", [torch.cat(parts).to(device) for parts in zip(*chips)]))
    return out


def replay(config, traffic, seed, data, norm, state0, device, control=False):
    """The reference's first steps: losses, the first gradient's and the
    change's per-leaf norms. ``control`` computes it in fp8."""
    from portbench.reference.lowp import fp8_compute

    batch_size = int(config["train"]["batch_size"])
    ref = reference_model(config, device)
    ref.load_state_dict(state0)
    train = dict(config["train"], edge_class=2)
    n = data["x"].shape[0]
    total = int(config["train"]["epochs"]) * max(1, n // batch_size)
    trainer = ReferenceTrainer(ref, train, total, compute=fp8_compute if control else None)
    generator = torch.Generator(device=device).manual_seed(program_seed(seed))
    norm_t = tuple(torch.from_numpy(v).to(device) for v in norm)
    losses = []
    for kind, payload in first_batches(traffic, seed, data, norm, device, batch_size, COMPARED_STEPS):
        if kind == "device":
            idx = payload
            x, y, bdist = device_batch(
                torch.from_numpy(data["x"][idx]).to(device),
                torch.from_numpy(data["y"][idx]).to(device),
                torch.from_numpy(data["bdist"][idx]).to(device),
                generator, norm_t, dihedral=True,
            )
        else:
            x, y, bdist = payload
        losses.append(trainer.step(x, y, bdist, generator))
    first_grad = compare.leaf_norms(trainer.first_grads)
    change = compare.leaf_norms({
        n: p.detach() - state0[n] for n, p in ref.named_parameters()
    })
    return {"losses": losses, "first_grad": first_grad, "change": change}


def readings(program, reference) -> T.Dict[str, float]:
    moving = compare.moving_leaves(reference["first_grad"])
    return {
        "loss_gap": compare.loss_gap(program["losses"], reference["losses"]),
        "first_grad_gap": compare.worst_leaf_gap(
            program["first_grad"], reference["first_grad"])[0],
        "change_gap": compare.worst_leaf_gap(
            program["change"], reference["change"], moving)[0],
        "first_grad_median_gap": compare.median_leaf_gap(
            program["first_grad"], reference["first_grad"]),
        "change_median_gap": compare.median_leaf_gap(
            program["change"], reference["change"], moving),
    }


def record_checks(ctx, program, reference) -> None:
    for name, value in readings(program, reference).items():
        ctx.check(name, value)
    moving = compare.moving_leaves(reference["first_grad"])
    for key, leaves in (("first_grad", None), ("change", moving)):
        gap, leaf = compare.worst_leaf_gap(program[key], reference[key], leaves)
        print(f"worst {key} leaf {leaf}: program {program[key][leaf]!r} "
              f"reference {reference[key][leaf]!r}", file=sys.stderr)
