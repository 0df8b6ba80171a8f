"""Readings that set the comparison limits, on a CUDA card at a cell's own
size: the control (the reference in the program's place, computed in
fp8) and, for a train cell, the fault of half the batch left out (the
mean taken over the rest), each against the fp32 reference on the same
weights, inputs and seeds. The benchmark's own runs never run these.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 [--look]

prints one JSON line a seed. ``--look`` adds, for a train cell, the
program's own first steps run in fp32 (TF32 off) against the reference:
the readings that show how much of a gap the program's bf16 compute
makes.
"""

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from portbench import compare, harness


def train_readings(ctx_cell, config, seed, device, fault=None):
    from portbench.drivers import train as driver
    from portbench.reference.step import ReferenceTrainer
    from portbench.traffic.fields import field_chips
    from portbench.weights import reference_model, seeded_state

    traffic = ctx_cell["traffic_params"]
    data = field_chips(traffic, seed, device)
    norm = driver.norm_stats(data["x"])
    ref = reference_model(config, device)
    state0 = seeded_state(ref, seed, driver.calibration_input(data, norm, device))
    del ref
    want = driver.replay(config, traffic, seed, data, norm, state0, device)
    out = {}
    got = driver.replay(config, traffic, seed, data, norm, state0, device, control=True)
    out["control"] = driver.readings(got, want)
    original = ReferenceTrainer.step

    def half_batch(self, x, y, bdist, generator):
        half = x.shape[0] // 2
        return original(self, x[:half], y[:half], bdist[:half], generator)

    ReferenceTrainer.step = half_batch
    try:
        got = driver.replay(config, traffic, seed, data, norm, state0, device)
    finally:
        ReferenceTrainer.step = original
    out["half_batch"] = driver.readings(got, want)
    return out


def fp32_look(cell, config, seed, device):
    """The train driver's set-up (the program's first steps and the
    reference's replay) with the program in fp32 and TF32 off, and no
    window: every number it compares, with the worst leaves on stderr."""
    from portbench.drivers import train as driver
    from portbench.trace import Tracer

    config = dict(config, train=dict(config["train"], precision="32"))
    workdir = Path(tempfile.mkdtemp(prefix="portbench-look-"))
    ctx = harness.Context(
        cell_name=cell["name"], cell=cell, config=config, seed=seed, seconds=0.0,
        trace=False, device=device, root=harness.ROOT, workdir=workdir,
        start=time.perf_counter(), tracer=Tracer(False, 1, 1, device),
    )
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        driver.run(ctx)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        shutil.rmtree(workdir, ignore_errors=True)
    return {**{c.name: c.value for c in ctx.checks}, **ctx.readings}


def forward_readings(cell, config, seed, device):
    from portbench.drivers import predict as pdriver
    from portbench.weights import reference_model, seeded_state

    traffic = cell["traffic_params"]
    if cell["driver"] == "predict":
        from portbench.traffic.scenes import scene_pool

        window, padding = int(traffic["window"]), int(traffic["padding"])
        scenes = scene_pool(traffic, seed, device)
        ref = reference_model(config, device)
        state0 = seeded_state(ref, seed, pdriver.calibration_input(scenes[0], window + 2 * padding, device))
        del ref
        blocks = pdriver.sample_blocks(seed, len(scenes), scenes[0].shape[1:3], window, traffic)
        args = (config, state0, scenes, blocks, window, padding, int(traffic["batch"]), device)
        want = np.stack(pdriver.reference_blocks(*args))
        got = np.stack(pdriver.reference_blocks(*args, control=True))
    else:
        from portbench.drivers import serve as sdriver
        from portbench.reference.lowp import fp8_compute
        from portbench.traffic.wire import wire_pool

        pool = wire_pool(traffic, seed, device)
        norm = sdriver.pool_norm(pool)
        norm_t = tuple(torch.from_numpy(v).to(device) for v in norm)
        x0 = torch.from_numpy(pool[0][0][:2]).to(device).float() / 10000.0
        ref = reference_model(config, device)
        state0 = seeded_state(ref, seed, (x0.clamp(1e-9, 1.0) - norm_t[0]) / norm_t[1])
        ref.load_state_dict(state0)
        ref.eval()
        calls = range(min(int(traffic["compared_calls"]), len(pool)))
        want = np.stack([pdriver.reference_forward(ref, pool[i][0], device, norm_t) for i in calls])
        with fp8_compute(ref):
            got = np.stack([pdriver.reference_forward(ref, pool[i][0], device, norm_t) for i in calls])
    mean_gap, max_gap = compare.output_gaps(got, want)
    return {"control": {"mean_abs_gap": mean_gap, "max_abs_gap": max_gap}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--look", action="store_true")
    args = parser.parse_args(argv)
    harness.cache_environment(harness.ROOT)
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = harness.load_json(harness.ROOT / "portbench" / "workloads" / f"{args.workload}.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = harness.load_json(harness.ROOT / entry["file"])
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda:0")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if cell["driver"] == "train":
            out = train_readings(cell, config, seed, device)
            if args.look:
                out["program_fp32"] = fp32_look(cell, config, seed, device)
        else:
            out = forward_readings(cell, config, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
