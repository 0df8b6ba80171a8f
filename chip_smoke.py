#!/usr/bin/env python3
"""Smoke test of the PyTorch port (cultionet_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. The first run
builds the CUDA kernels from ``cultionet_tpu_torch/ops/csrc/`` into
``cultionet_tpu_torch/_build/``.

It prints one JSON line per phase and fails (non-zero exit, no result line)
on the first phase that fails:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA.
2. build: every kernel of the path, compiled in parallel, with nvcc's
   register and spill report.
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it (fp32 <= 1e-5; bf16 <= 2e-2 against
   the plain version in fp32 on the same bf16 inputs), at ragged shapes and
   larger kernel sizes; times (median of CUDA-event-timed launches) beside
   the bound and the plain version's time.
4. model: the full-width CLI-default CultioNet (hidden 64, T=12, 140-px
   windows, B=8, seeded weights) with the kernel and with the plain
   attention (fp32, <= 1e-4), and against the CPU on a small input.
5. predict (the main path): ScenePredictor.predict_scene at bf16 on a
   seeded int16 scene (T=12, 420x420, C=3, window 100, padding 20: 25
   windows in 4 batches of 8). Kernel launch counts are zeroed just before
   and read just after.
6. forward profile: device time by kernel for one bf16 window batch.

Then the kernels line, and last ``{"ok": true, "device": {...}}``.
TF32 is off for matmuls and convolutions throughout, so fp32 comparisons
hold fp32 arithmetic.
"""

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s and fp32 FLOP/s
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

MODEL_SHAPES = [  # (B, H, W, heads, head_dim, kernel, dilation): up_cu, up_bu, up_au
    (8, 35, 35, 8, 32, 3, 1),
    (8, 70, 70, 4, 64, 3, 1),
    (8, 140, 140, 4, 64, 3, 2),
]
EXTRA_SHAPES = [  # the last predict batch, ragged cosets, larger kernels
    (1, 140, 140, 4, 64, 3, 2),
    (2, 35, 37, 4, 16, 3, 2),
    (2, 37, 35, 8, 32, 3, 3),
    (4, 35, 35, 8, 32, 5, 1),
    (4, 35, 35, 8, 32, 7, 1),
    (2, 30, 31, 2, 70, 7, 2),
]


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def require(cond: bool, message: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {message}")


def median_ms(fn, iters: int = 25, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def fused_qkv(shape, dtype, generator):
    """q, k, v as the model makes them: strided thirds of one projection."""
    b, h, w, n, d, _, _ = shape
    qkv = torch.randn(
        b, h, w, 3 * n * d, device="cuda", generator=generator
    ).to(dtype)
    return [t.unflatten(-1, (n, -1)) for t in qkv.chunk(3, -1)]


def na_bound_ms(shape, itemsize: int):
    b, h, w, n, d, k, _ = shape
    numel = b * h * w * n * d
    bytes_moved = 4 * numel * itemsize  # q, k, v read once, out written once
    ops = b * h * w * n * k * k * (4 * d + 3)  # two dots, exp, sub, scale
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit(
        {
            "phase": "device",
            "nvidia_smi": smi,
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "python": sys.version.split()[0],
        }
    )
    return smi


def phase_build() -> None:
    from cultionet_tpu_torch.ops import natten_cuda

    builds = {"na2d_fwd": natten_cuda.compile_library}
    start = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        futures = {
            name: pool.submit(build, verbose=True)
            for name, build in builds.items()
        }
        reports = {name: f.result() for name, f in futures.items()}
    seconds = time.perf_counter() - start
    natten_cuda.load_library()
    for name, (path, log) in reports.items():
        emit(
            {
                "phase": "build",
                "kernel": name,
                "library": str(path.name),
                "ptxas": [
                    line.strip()
                    for line in log.splitlines()
                    if "registers" in line or "spill" in line
                ],
            }
        )
    emit({"phase": "build", "seconds": seconds})


def phase_kernels() -> dict:
    from cultionet_tpu_torch.ops.natten import neighborhood_attention_2d
    from cultionet_tpu_torch.ops.natten_cuda import na2d_cuda

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16_err = 0.0
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    bound_by = set()
    for shape in MODEL_SHAPES + EXTRA_SHAPES:
        k, d = shape[5], shape[6]
        model_shape = shape in MODEL_SHAPES
        for dtype in (torch.float32, torch.bfloat16):
            if not model_shape and dtype == torch.bfloat16 and shape[0] > 1:
                continue
            q, kk, v = fused_qkv(shape, dtype, gen)
            out = na2d_cuda(q, kk, v, k, d)
            ref = neighborhood_attention_2d(q.float(), kk.float(), v.float(), k, d)
            torch.cuda.synchronize()
            err = (out.float() - ref).abs().max().item()
            tol = 1e-5 if dtype == torch.float32 else 2e-2
            record = {
                "phase": "kernel_check",
                "kernel": "na2d_fwd",
                "shape": list(shape[:5]),
                "kernel_size": k,
                "dilation": d,
                "dtype": str(dtype).replace("torch.", ""),
                "max_abs_err": err,
                "tol": tol,
            }
            require(bool(torch.isfinite(out).all()), f"non-finite {record}")
            require(err <= tol, f"kernel disagrees with plain: {record}")
            if model_shape:
                bound, by = na_bound_ms(shape, q.element_size())
                record["ms"] = median_ms(lambda: na2d_cuda(q, kk, v, k, d))
                record["plain_ms"] = median_ms(
                    lambda: neighborhood_attention_2d(q, kk, v, k, d),
                    iters=10,
                )
                record["bound_ms"] = bound
                record["bound_by"] = by
                if dtype == torch.bfloat16:  # the predict path's dtype
                    bf16_err = max(bf16_err, err)
                    for key in totals:
                        totals[key] += record[key]
                    bound_by.add(by)
            emit(record)
            del q, kk, v, out, ref
    torch.cuda.empty_cache()
    return {
        "max_abs_err": bf16_err,
        **totals,
        "bound_by": "bytes" if bound_by == {"bytes"} else "operations",
    }


def build_model():
    from cultionet_tpu_torch.models import CultioNet
    from cultionet_tpu_torch.nn.init import init_parameters_

    model = CultioNet(
        in_time=12, in_channels=3, hidden_channels=64, dilations=[1, 2],
        dropout=0.2, activation_type="SiLU", attention_weights="natten",
    )
    init_parameters_(model, torch.Generator().manual_seed(0))
    return model.eval()


def check_outputs(outputs, shape, label):
    for name in ("distance", "edge", "crop"):
        value = outputs[name]
        require(tuple(value.shape) == shape, f"{label} {name} {value.shape}")
        require(bool(torch.isfinite(value).all()), f"{label} {name} non-finite")
        lo, hi = value.min().item(), value.max().item()
        require(0.0 <= lo and hi <= 1.0, f"{label} {name} in [{lo}, {hi}]")


def phase_model(model) -> None:
    from cultionet_tpu_torch.ops import natten_cuda
    from cultionet_tpu_torch.ops.flags import set_cuda_natten

    gpu_model = model.to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.rand(8, 12, 140, 140, 3, device="cuda", generator=gen)
    with torch.inference_mode():
        before = natten_cuda.LAUNCHES["na2d_fwd"]
        kernel_out = gpu_model(x)
        launches = natten_cuda.LAUNCHES["na2d_fwd"] - before
        set_cuda_natten(False)
        try:
            plain_out = gpu_model(x)
        finally:
            set_cuda_natten(True)
        forward_ms = median_ms(lambda: gpu_model(x), iters=5, warmup=1)
    check_outputs(kernel_out, (8, 140, 140, 1), "model")
    check_outputs(plain_out, (8, 140, 140, 1), "model (plain NA)")
    require(launches == 3, f"model forward launched na2d_fwd {launches}x")
    err = max(
        (kernel_out[n] - plain_out[n]).abs().max().item()
        for n in ("distance", "edge", "crop")
    )
    require(err <= 1e-4, f"model: kernel vs plain NA max-abs {err}")
    emit(
        {
            "phase": "model",
            "input": [8, 12, 140, 140, 3],
            "dtype": "float32",
            "na2d_launches": launches,
            "kernel_vs_plain_max_abs": err,
            "forward_ms": forward_ms,
        }
    )

    # The card against the CPU (plain attention, CPU convolutions) on a
    # small input: same weights, fp32.
    xs = torch.rand(1, 12, 44, 44, 3, generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        gpu_small = gpu_model(xs.cuda())
        cpu_small = model.to("cpu")(xs)
    model.to("cuda")
    err = max(
        (gpu_small[n].cpu() - cpu_small[n]).abs().max().item()
        for n in ("distance", "edge", "crop")
    )
    require(err <= 1e-4, f"model: card vs CPU max-abs {err}")
    emit({"phase": "model_vs_cpu", "input": [1, 12, 44, 44, 3], "max_abs": err})


def phase_predict(model) -> dict:
    from cultionet_tpu_torch.ops import natten_cuda
    from cultionet_tpu_torch.predict import ScenePredictor

    scene = (
        np.random.default_rng(0).random((12, 420, 420, 3)) * 10000.0
    ).astype("int16")
    predictor = ScenePredictor(model, batch_size=8, precision="bf16", device="cuda")
    predictor.predict_scene(scene, window_size=100, padding=20)  # warm-up

    for name in natten_cuda.LAUNCHES:
        natten_cuda.LAUNCHES[name] = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    raster, (h, w) = predictor.predict_scene(scene, window_size=100, padding=20)
    seconds = time.perf_counter() - start
    launches = dict(natten_cuda.LAUNCHES)

    require(raster.shape == (420, 420, 3), f"raster shape {raster.shape}")
    require((h, w) == (420, 420), f"scene size {(h, w)}")
    require(bool(np.isfinite(raster).all()), "raster not finite")
    lo, hi = float(raster.min()), float(raster.max())
    require(0.0 <= lo and hi <= 1.0, f"raster in [{lo}, {hi}]")
    windows = 25
    require(
        launches["na2d_fwd"] == 3 * 4,
        f"predict launched na2d_fwd {launches['na2d_fwd']}x, expected 12",
    )
    emit(
        {
            "phase": "predict",
            "scene": [12, 420, 420, 3],
            "windows": windows,
            "batches": 4,
            "precision": "bf16",
            "seconds": seconds,
            "windows_per_s": windows / seconds,
            "raster_min": lo,
            "raster_max": hi,
            "launches": launches,
        }
    )
    return launches


def phase_profile(model) -> None:
    from torch.profiler import ProfilerActivity, profile

    run = model.to("cuda", torch.bfloat16)
    x = torch.rand(8, 12, 140, 140, 3, device="cuda").to(torch.bfloat16)
    with torch.inference_mode():
        run(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run(x)
            torch.cuda.synchronize()
    events = [
        e for e in prof.key_averages() if getattr(e, "device_time_total", 0) > 0
    ]
    total_us = sum(e.device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.device_time_total)[:8]
    na_us = sum(e.device_time_total for e in events if "na2d_fwd" in e.key)
    emit(
        {
            "phase": "forward_profile",
            "input": [8, 12, 140, 140, 3],
            "dtype": "bfloat16",
            "device_ms": total_us / 1e3,
            "na2d_fwd_share": na_us / total_us if total_us else None,
            "top": [
                {
                    "kernel": e.key[:80],
                    "ms": e.device_time_total / 1e3,
                    "calls": e.count,
                }
                for e in top
            ],
        }
    )


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_device()
    phase_build()
    summary = phase_kernels()
    model = build_model()
    phase_model(model)
    launches = phase_predict(model)
    phase_profile(model)

    emit(
        {
            "kernels": [
                {
                    "name": "na2d_fwd",
                    "route": "cuda",
                    "source": "cultionet_tpu_torch/ops/csrc/na2d_fwd.cu",
                    "replaces": "cultionet_tpu/ops/natten_pallas.py:453",
                    "launches": launches["na2d_fwd"],
                    "max_abs_err": summary["max_abs_err"],
                    "ms": summary["ms"],
                    "plain_ms": summary["plain_ms"],
                    "bound_ms": summary["bound_ms"],
                    "bound_by": summary["bound_by"],
                    "library_ms": None,
                }
            ]
        }
    )
    emit(
        {
            "ok": True,
            "device": {
                "platform": "gpu",
                "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count(),
            },
        }
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
