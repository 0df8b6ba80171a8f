"""Predict cells: ``ScenePredictor.predict_scene`` over whole scenes,
back to back, from a pool of seeded int16 scenes on the host.

After the window, a sample of the completed scenes' rasters, drawn from
the seed, is held against the reference: for each sampled block (one
window's interior) the reference runs every window that overlaps it in
fp32 and blends them with the same taper weights.
"""

import time
import typing as T

import numpy as np
import torch

from portbench import compare
from portbench.reference.step import taper_weights
from portbench.roofline import count_model
from portbench.trace import layer
from portbench.traffic.scenes import scene_pool
from portbench.weights import reference_model, seeded_state


def calibration_input(scene: np.ndarray, size: int, device) -> torch.Tensor:
    x = torch.from_numpy(scene[:, :size, :size]).to(device).float() / 10000.0
    return x[None]


def run(ctx) -> None:
    from cultionet_tpu_torch.models import CultioNet
    from cultionet_tpu_torch.predict import ScenePredictor

    traffic, config, device = ctx.traffic, ctx.config, ctx.device
    window, padding = int(traffic["window"]), int(traffic["padding"])
    size = window + 2 * padding
    batch = int(traffic["batch"])
    scenes = scene_pool(traffic, ctx.seed, device)
    ref = reference_model(config, device)
    state0 = seeded_state(ref, ctx.seed, calibration_input(scenes[0], size, device))
    del ref
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    model = CultioNet(**config["model"])
    model.load_state_dict(state0)
    predictor = ScenePredictor(
        model, batch_size=batch, precision=traffic["precision"], device=device
    )
    # Warm-up: a corner of the first scene, whole batches of windows.
    corner = window * int(np.ceil(np.sqrt(batch)))
    predictor.predict_scene(
        scenes[0][:, :corner, :corner], window_size=window, padding=padding
    )
    windows_per_scene = int(np.ceil(scenes[0].shape[1] / window) * np.ceil(scenes[0].shape[2] / window))
    ctx.setup_done()

    rasters: T.List[np.ndarray] = []
    start = time.perf_counter()
    while time.perf_counter() - start < ctx.seconds:
        scene = scenes[len(rasters) % len(scenes)]
        with layer("predict.scene"):
            raster, _ = predictor.predict_scene(scene, window_size=window, padding=padding)
        rasters.append(raster)
        ctx.tracer.step()
    ctx.window_s = time.perf_counter() - start
    ctx.tracer.close()
    ctx.attempted = ctx.units = len(rasters)
    ctx.extra["calls_per_unit"] = int(np.ceil(windows_per_scene / batch))
    ctx.metrics["predict_windows_per_s"] = len(rasters) * windows_per_scene / ctx.window_s
    ctx.read_peak_memory()
    if ctx.trace:
        ctx.counts = count_model(
            config["model"], (batch, scenes[0].shape[0], size, size, scenes[0].shape[-1]),
            backward=False,
        )
    del predictor, model
    if device.type == "cuda":
        torch.cuda.empty_cache()

    blocks = sample_blocks(ctx.seed, len(rasters), scenes[0].shape[1:3], window, traffic)
    got = [rasters[i][r: r + window, c: c + window] for i, r, c in blocks]
    want = reference_blocks(config, state0, scenes, blocks, window, padding, batch, device)
    mean_gap, max_gap = compare.output_gaps(np.stack(got), np.stack(want))
    ctx.check("mean_abs_gap", mean_gap)
    ctx.check("max_abs_gap", max_gap)


def sample_blocks(seed, completed, shape, window, traffic) -> T.List[T.Tuple[int, int, int]]:
    """(scene index, row, col) of the sampled window interiors, drawn from
    the seed among the completed scenes."""
    rng = np.random.default_rng(seed)
    rows, cols = int(np.ceil(shape[0] / window)), int(np.ceil(shape[1] / window))
    out = []
    for _ in range(int(traffic["sample_blocks"])):
        i = int(rng.integers(0, completed))
        out.append((i, int(rng.integers(0, rows)) * window, int(rng.integers(0, cols)) * window))
    return out


def window_jobs(height: int, width: int, window: int, padding: int):
    """Each window's offsets, its read slice and its top/left zero pad."""
    for row in range(0, height, window):
        for col in range(0, width, window):
            h, w = min(window, height - row), min(window, width - col)
            r0, c0 = max(0, row - padding), max(0, col - padding)
            r1, c1 = min(height, row + h + padding), min(width, col + w + padding)
            yield row, col, (r0, r1, c0, c1), padding - (row - r0), padding - (col - c0)


def cut(scene: np.ndarray, job, size: int) -> np.ndarray:
    _, _, (r0, r1, c0, c1), top, left = job
    w = scene[:, r0:r1, c0:c1]
    w = np.pad(w, ((0, 0), (top, 0), (left, 0), (0, 0)))
    return np.pad(w, ((0, 0), (0, size - w.shape[1]), (0, size - w.shape[2]), (0, 0)))


@torch.no_grad()
def reference_forward(ref, windows: np.ndarray, device, norm=None) -> np.ndarray:
    """(B, S, S, 3) fp32 heads of int16 windows; with ``norm`` the served
    pipeline's clip and z-score first."""
    from portbench.reference.step import dequantize

    x = dequantize(torch.from_numpy(windows).to(device))
    if norm is not None:
        x = (x.clamp(1e-9, 1.0) - norm[0]) / norm[1]
    out = ref(x)
    return torch.cat(
        [out[k].float() for k in ("distance", "edge", "crop")], dim=-1
    ).cpu().numpy()


def reference_blocks(config, state0, scenes, blocks, window, padding, batch, device,
                     control=False) -> T.List[np.ndarray]:
    """The reference raster on each sampled block: every window that
    overlaps the block, run in blocks of ``batch`` and blended."""
    from portbench.reference.lowp import fp8_compute
    import contextlib

    ref = reference_model(config, device)
    ref.load_state_dict(state0)
    ref.eval()
    size = window + 2 * padding
    weights = taper_weights(window, padding, "cpu").numpy()[..., None]
    out = []
    for i, row, col in blocks:
        scene = scenes[i % len(scenes)]
        _, height, width, _ = scene.shape
        jobs = [
            j for j in window_jobs(height, width, window, padding)
            if abs(j[0] - row) <= window and abs(j[1] - col) <= window
        ]
        preds = []
        for k in range(0, len(jobs), batch):
            chunk = np.stack([cut(scene, j, size) for j in jobs[k: k + batch]])
            with fp8_compute(ref) if control else contextlib.nullcontext():
                preds.append(reference_forward(ref, chunk, device))
        preds = np.concatenate(preds)
        total = np.zeros((window, window, 3), np.float64)
        weight = np.full((window, window, 1), 1e-8, np.float64)
        for j, pred in zip(jobs, preds):
            # The window's top-left pixel lies at scene (row0 - padding).
            r_off = j[0] - padding - row
            c_off = j[1] - padding - col
            rs, cs = max(0, r_off), max(0, c_off)
            re, ce = min(window, r_off + size), min(window, c_off + size)
            if rs >= re or cs >= ce:
                continue
            total[rs:re, cs:ce] += pred[rs - r_off: re - r_off, cs - c_off: ce - c_off] * weights[rs - r_off: re - r_off, cs - c_off: ce - c_off]
            weight[rs:re, cs:ce] += weights[rs - r_off: re - r_off, cs - c_off: ce - c_off]
        out.append((total / weight).astype(np.float32))
    return out
