"""Serve cells: one caller in a closed loop calls an exported artifact
(``export.py``: the program exported for the card in bf16, then
``load_predictor``) on wire-format batches from a pool, each call timed
from the call to the outputs on the host.

Calls are kept for the comparison by a draw from the seed made before
the window; after it, the kept calls' heads are held against the
reference's (dequantize, clip, z-score, the fp32 model) on the same
inputs.
"""

import time

import numpy as np
import torch

from portbench import compare
from portbench.harness import quantile
from portbench.roofline import count_model
from portbench.trace import layer
from portbench.traffic.wire import wire_pool
from portbench.weights import reference_model, seeded_state
from portbench.drivers.predict import reference_forward

KEEP_DRAWS = 1 << 20


def pool_norm(pool):
    """Per-band mean and std of the pool's reflectance, float64."""
    flat = np.concatenate([x.reshape(-1, x.shape[-1]) for x, _, _ in pool])
    flat = np.clip(flat.astype(np.float64) / 10000.0, 1e-9, 1.0)
    return flat.mean(0).astype(np.float32), flat.std(0).astype(np.float32)


def run(ctx) -> None:
    from cultionet_tpu_torch.export import export_state, load_predictor
    from cultionet_tpu_torch.models import CultioNet

    traffic, config, device = ctx.traffic, ctx.config, ctx.device
    pool = wire_pool(traffic, ctx.seed, device)
    norm = pool_norm(pool)
    norm_t = tuple(torch.from_numpy(v).to(device) for v in norm)
    x0 = torch.from_numpy(pool[0][0][:2]).to(device).float() / 10000.0
    ref = reference_model(config, device)
    state0 = seeded_state(ref, ctx.seed, (x0.clamp(1e-9, 1.0) - norm_t[0]) / norm_t[1])
    del ref
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    model = CultioNet(**config["model"])
    model.load_state_dict(state0)
    model = model.to(device)
    artifact = export_state(
        model, ctx.workdir / "serve.cnx",
        in_time=int(traffic["time"]), in_channels=int(traffic["bands"]),
        batch_size=int(traffic["batch"]), chip_size=int(traffic["window"]),
        precision=traffic["precision"], norm_mean=norm[0], norm_std=norm[1],
        device=device,
    )
    del model
    predictor = load_predictor(artifact)
    for x, lat, lon in pool[: int(traffic["warmup_calls"])]:
        predictor(x, lat, lon)
    keep = np.random.default_rng(ctx.seed).random(KEEP_DRAWS) < float(traffic["keep_share"])
    keep[0] = True  # at least one call is compared, however short the window
    ctx.setup_done()

    latencies, kept = [], {}
    start = time.perf_counter()
    while time.perf_counter() - start < ctx.seconds:
        i = len(latencies)
        x, lat, lon = pool[i % len(pool)]
        t0 = time.perf_counter()
        with layer("serve.call"):
            out = predictor(x, lat, lon)
        latencies.append(time.perf_counter() - t0)
        if keep[i % KEEP_DRAWS]:
            kept[i] = out
        ctx.tracer.step()
    ctx.window_s = time.perf_counter() - start
    ctx.tracer.close()
    ctx.attempted = ctx.units = len(latencies)
    ctx.metrics["serve_p95_ms"] = quantile(latencies, 95) * 1e3
    ctx.extra["serve_median_ms"] = quantile(latencies, 50) * 1e3
    ctx.read_peak_memory()
    if ctx.trace:
        ctx.counts = count_model(config["model"], pool[0][0].shape, backward=False)
    del predictor
    if device.type == "cuda":
        torch.cuda.empty_cache()

    calls = sorted(kept)[: int(traffic["compared_calls"])]
    ref = reference_model(config, device)
    ref.load_state_dict(state0)
    ref.eval()
    got, want = [], []
    for i in calls:
        x, _, _ = pool[i % len(pool)]
        got.append(np.concatenate([kept[i][k] for k in ("distance", "edge", "crop")], -1))
        want.append(reference_forward(ref, x, device, norm_t))
    mean_gap, max_gap = compare.output_gaps(np.stack(got), np.stack(want))
    ctx.check("mean_abs_gap", mean_gap)
    ctx.check("max_abs_gap", max_gap)
