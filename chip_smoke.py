#!/usr/bin/env python3
"""Smoke test of the PyTorch port (cultionet_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. The first run
builds the CUDA kernels from ``cultionet_tpu_torch/ops/csrc/`` into
``cultionet_tpu_torch/_build/``.

It prints one JSON line per phase and fails (non-zero exit, no result line)
on the first phase that fails:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA.
2. build: every kernel library, compiled in parallel (one nvcc per
   source), with nvcc's register and spill report.
3. kernel_check na2d_fwd: the NA forward against its plain PyTorch version
   on the card, at the predict path's shapes (fp32 <= 1e-5; bf16 <= 2e-2
   against the plain version in fp32 on the same bf16 inputs), at ragged
   shapes and larger kernel sizes; times (median of CUDA-event-timed
   launches) beside the bound and the plain version's time.
4. kernel_check na2d_fwd_drop: the dropout forward at the train path's
   shapes: at p = 0 equal to na2d_fwd bit for bit; at p = 0.2 against the
   plain version given ``dropout_keep_mask`` of the same seed (same
   limits); its keep rate (read from the kernel's output) within
   0.8 +- 0.002; two seeds, two masks.
5. kernel_check na2d_bwd / na2d_bwd_drop: dq, dk, dv against autograd of
   the plain version (with the same mask for the dropout variant) at the
   train shapes and the ragged and k = 5/7 shapes (fp32 <= 1e-4; bf16
   <= 5e-2 against the fp32 plain version on the same bf16 inputs); times
   beside the bound and the plain version's forward + backward.
6. model: the full-width CLI-default CultioNet (hidden 64, T=12, 140-px
   windows, B=8, seeded weights, BatchNorm statistics estimated by
   training-mode passes) with the kernel and with the plain attention
   (fp32, <= 1e-4), and against the CPU on a small input.
7. predict (main path 1): ScenePredictor.predict_scene at bf16 on a seeded
   int16 scene (T=12, 420x420, C=3, window 100, padding 20: 25 windows in
   4 batches of 8).
8. forward_profile: device time by kernel for one bf16 window batch.
9. train (main path 2): the CLI-default train step (hidden 64, dropout
   0.2, TanimotoComplementLoss, AdamW + OneCycle + global-norm clip 1.0,
   "16-mixed") on one fixed seeded batch of 4 chips of 100x100, T=12, 3
   bands: 3 warm-up steps, then 20 timed steps. Every loss finite, the
   last below the first, exactly 3 launches of na2d_fwd_drop and of
   na2d_bwd_drop per step and none of the no-dropout kernels.
10. train_parity (path 3, dropout 0): one fp32 step launches na2d_fwd and
    na2d_bwd 3 times each; its loss and gradients with the kernels
    against the plain attention, and on the card against the CPU.
11. eval: make_eval_step at bf16 on the trained state: finite metrics,
    F-scores in [0, 1], MCC in [-1, 1].
12. train_profile: device time by kernel for one bf16 train step, and
    host time by operator for another (the profiler's own overhead
    included).

Kernel launch counts are zeroed just before each path (7, 9, 10) and read
just after. Then the kernels line, and last ``{"ok": true, "device":
{...}}``. TF32 is off for matmuls and convolutions throughout, so fp32
comparisons hold fp32 arithmetic.
"""

import json
import statistics
import subprocess
import sys
import time
import typing as T
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
TRAIN_STEPS = 23  # 3 warm-up and 20 timed steps on one batch
TRAIN_WARMUP = 3
TRAIN_SHAPES = [  # 100-px training chips, B=4: up_cu, up_bu, up_au
    (4, 25, 25, 8, 32, 3, 1),
    (4, 50, 50, 4, 64, 3, 1),
    (4, 100, 100, 4, 64, 3, 2),
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


def na_bwd_bound_ms(shape, itemsize: int):
    """q, k, v and g read once, dq, dk and dv written once; operations:
    logits, g . v, dq, dk and dv, 2*D each per window slot, plus the
    softmax and its backward."""
    b, h, w, n, d, k, _ = shape
    numel = b * h * w * n * d
    bytes_moved = 7 * numel * itemsize
    ops = b * h * w * n * k * k * (10 * d + 8)
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def zero_launches() -> None:
    from cultionet_tpu_torch.ops import natten_cuda

    torch.cuda.synchronize()
    for name in natten_cuda.LAUNCHES:
        natten_cuda.LAUNCHES[name] = 0


def read_launches() -> dict:
    from cultionet_tpu_torch.ops import natten_cuda

    torch.cuda.synchronize()
    return dict(natten_cuda.LAUNCHES)


def summarize(records, dtype) -> dict:
    """Sums of ms, plain_ms and bound_ms over the timed records of
    ``dtype``, their largest error and what bounds them."""
    chosen = [r for r in records if r["dtype"] == dtype and "ms" in r]
    bound_by = {r["bound_by"] for r in chosen}
    return {
        "max_abs_err": max(r["max_abs_err"] for r in chosen),
        "ms": sum(r["ms"] for r in chosen),
        "plain_ms": sum(r["plain_ms"] for r in chosen),
        "bound_ms": sum(r["bound_ms"] for r in chosen),
        "bound_by": "bytes" if bound_by == {"bytes"} else "operations",
    }


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

    names = list(natten_cuda.SOURCES)
    start = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        futures = {
            name: pool.submit(natten_cuda.compile_library, name, verbose=True)
            for name in names
        }
        reports = {name: f.result() for name, f in futures.items()}
    seconds = time.perf_counter() - start
    for name in names:
        natten_cuda.load_library(name)
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
    records = []
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
            emit(record)
            records.append(record)
            del q, kk, v, out, ref
    torch.cuda.empty_cache()
    return summarize(records, "bfloat16")  # the predict path's dtype


def build_model():
    """The CLI-default model with seeded weights, on the card, in eval
    mode, its BatchNorm running statistics estimated by 20 training-mode
    passes over seeded random windows, as a trained model's are. Left at
    their initial values, the random network amplifies fp32 round-off
    about 30 times more (fp32 against fp64 outputs: 6.2e-5 against 2.0e-6
    on a 2 x 44 x 44 input, on the CPU), which the model phase's fp32
    comparisons would read as kernel error."""
    from cultionet_tpu_torch.models import CultioNet
    from cultionet_tpu_torch.nn.dropout import dropout_rng
    from cultionet_tpu_torch.nn.init import init_parameters_

    model = CultioNet(
        in_time=12, in_channels=3, hidden_channels=64, dilations=[1, 2],
        dropout=0.2, activation_type="SiLU", attention_weights="natten",
    )
    init_parameters_(model, torch.Generator().manual_seed(0))
    model.to("cuda").train()
    gen = torch.Generator(device="cuda").manual_seed(7)
    with torch.no_grad(), dropout_rng(gen):
        for _ in range(20):
            model(torch.rand(8, 12, 140, 140, 3, device="cuda", generator=gen))
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
    from cultionet_tpu_torch.predict import ScenePredictor

    scene = (
        np.random.default_rng(0).random((12, 420, 420, 3)) * 10000.0
    ).astype("int16")
    predictor = ScenePredictor(model, batch_size=8, precision="bf16", device="cuda")
    predictor.predict_scene(scene, window_size=100, padding=20)  # warm-up

    zero_launches()
    start = time.perf_counter()
    raster, (h, w) = predictor.predict_scene(scene, window_size=100, padding=20)
    seconds = time.perf_counter() - start
    launches = read_launches()

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


def device_time_by_kernel(prof, count: int):
    """The profile's kernels with device time, their total in us, and the
    ``count`` largest as records."""
    events = [
        e for e in prof.key_averages() if getattr(e, "device_time_total", 0) > 0
    ]
    total_us = sum(e.device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.device_time_total)[:count]
    return events, total_us, [
        {"kernel": e.key[:80], "ms": e.device_time_total / 1e3, "calls": e.count}
        for e in top
    ]


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
    events, total_us, top = device_time_by_kernel(prof, 8)
    na_us = sum(e.device_time_total for e in events if "na2d_fwd" in e.key)
    emit(
        {
            "phase": "forward_profile",
            "input": [8, 12, 140, 140, 3],
            "dtype": "bfloat16",
            "device_ms": total_us / 1e3,
            "na2d_fwd_share": na_us / total_us if total_us else None,
            "top": top,
        }
    )


def phase_fwd_drop() -> dict:
    from cultionet_tpu_torch.ops.natten import (
        dropout_keep_mask,
        neighborhood_attention_2d,
    )
    from cultionet_tpu_torch.ops.natten_cuda import launch_na2d_fwd

    p = 0.2
    gen = torch.Generator(device="cuda").manual_seed(3)
    seed = torch.tensor([12345], dtype=torch.int32, device="cuda")
    records = []
    kept = slots = mask_kept = 0.0
    for shape in TRAIN_SHAPES:
        b, h, w, n, d, k, dil = shape
        # Keep rate from the kernel itself: with q = k = 0 every weight is
        # 1 / k^2, so with v = 1 each output is (kept slots / k^2) / (1 - p).
        zeros = torch.zeros(b, h, w, n, d, device="cuda")
        ones = torch.ones(b, h, w, n, d, device="cuda")
        out = launch_na2d_fwd(zeros, zeros, ones, k, dil, p, seed)
        counts = torch.round(out[..., 0].double() * (1 - p) * k * k)
        mask = dropout_keep_mask(seed, (b, h, w, n, k * k), p)
        mask_counts = (mask > 0).sum(-1).double()
        require(
            torch.equal(counts, mask_counts),
            f"kernel keep counts differ from dropout_keep_mask {shape}",
        )
        kept += counts.sum().item()
        mask_kept += mask_counts.sum().item()
        slots += b * h * w * n * k * k
        other = launch_na2d_fwd(
            zeros, zeros, ones, k, dil, p, seed + 1
        )
        differ = (other[..., 0] != out[..., 0]).double().mean().item()
        require(differ > 0.5, f"seeds 12345, 12346 give alike masks {differ}")

        for dtype in (torch.float32, torch.bfloat16):
            q, kk, v = fused_qkv(shape, dtype, gen)
            base = launch_na2d_fwd(q, kk, v, k, dil)
            at_zero = launch_na2d_fwd(q, kk, v, k, dil, 0.0, seed)
            require(
                torch.equal(base, at_zero),
                f"na2d_fwd_drop at p=0 differs from na2d_fwd {shape}",
            )
            out = launch_na2d_fwd(q, kk, v, k, dil, p, seed)
            mask = dropout_keep_mask(seed, (b, h, w, n, k * k), p)
            ref = neighborhood_attention_2d(
                q.float(), kk.float(), v.float(), k, dil,
                weights_fn=lambda wts: wts * mask,
            )
            err = (out.float() - ref).abs().max().item()
            tol = 1e-5 if dtype == torch.float32 else 2e-2
            record = {
                "phase": "kernel_check",
                "kernel": "na2d_fwd_drop",
                "shape": list(shape[:5]),
                "kernel_size": k,
                "dilation": dil,
                "dtype": str(dtype).replace("torch.", ""),
                "attn_drop": p,
                "max_abs_err": err,
                "tol": tol,
            }
            require(bool(torch.isfinite(out).all()), f"non-finite {record}")
            require(err <= tol, f"kernel disagrees with plain: {record}")
            bound, by = na_bound_ms(shape, q.element_size())
            record["ms"] = median_ms(
                lambda: launch_na2d_fwd(q, kk, v, k, dil, p, seed)
            )
            record["plain_ms"] = median_ms(
                lambda: neighborhood_attention_2d(
                    q, kk, v, k, dil,
                    weights_fn=lambda wts: wts * mask.to(wts.dtype),
                ),
                iters=10,
            )
            record["bound_ms"] = bound
            record["bound_by"] = by
            emit(record)
            records.append(record)
            del q, kk, v, out, ref, base, at_zero
    rate = kept / slots
    emit(
        {
            "phase": "kernel_check",
            "kernel": "na2d_fwd_drop",
            "keep_rate": rate,
            "mask_keep_rate": mask_kept / slots,
            "slots": slots,
        }
    )
    require(abs(rate - (1 - p)) <= 0.002, f"keep rate {rate}")
    require(kept == mask_kept, f"kernel kept {kept}, mask {mask_kept}")
    torch.cuda.empty_cache()
    return summarize(records, "bfloat16")


def phase_bwd() -> T.Dict[str, dict]:
    from cultionet_tpu_torch.ops.natten import (
        dropout_keep_mask,
        neighborhood_attention_2d,
    )
    from cultionet_tpu_torch.ops.natten_cuda import launch_na2d_bwd

    gen = torch.Generator(device="cuda").manual_seed(4)
    seed = torch.tensor([777], dtype=torch.int32, device="cuda")
    records = {"na2d_bwd": [], "na2d_bwd_drop": []}
    for shape in TRAIN_SHAPES + EXTRA_SHAPES:
        b, h, w, n, d, k, dil = shape
        train_shape = shape in TRAIN_SHAPES
        for dtype in (torch.float32, torch.bfloat16):
            if not train_shape and dtype == torch.bfloat16:
                continue
            q, kk, v = fused_qkv(shape, dtype, gen)
            g = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
            for name, p in (("na2d_bwd", 0.0), ("na2d_bwd_drop", 0.2)):
                run_seed, weights_fn = None, None
                if p > 0:
                    run_seed = seed
                    mask = dropout_keep_mask(seed, (b, h, w, n, k * k), p)

                    def weights_fn(wts, mask=mask):
                        return wts * mask.to(wts.dtype)

                got = launch_na2d_bwd(q, kk, v, g, k, dil, p, run_seed)
                leaves = [
                    t.detach().float().requires_grad_() for t in (q, kk, v)
                ]
                ref = torch.autograd.grad(
                    neighborhood_attention_2d(
                        *leaves, k, dil, weights_fn=weights_fn
                    ),
                    leaves,
                    g.float(),
                )
                errs = [
                    (a.float() - r).abs().max().item()
                    for a, r in zip(got, ref)
                ]
                tol = 1e-4 if dtype == torch.float32 else 5e-2
                record = {
                    "phase": "kernel_check",
                    "kernel": name,
                    "shape": list(shape[:5]),
                    "kernel_size": k,
                    "dilation": dil,
                    "dtype": str(dtype).replace("torch.", ""),
                    "attn_drop": p,
                    "max_abs_err_dq_dk_dv": errs,
                    "max_abs_err": max(errs),
                    "tol": tol,
                }
                require(
                    all(bool(torch.isfinite(t).all()) for t in got),
                    f"non-finite {record}",
                )
                require(max(errs) <= tol, f"kernel disagrees: {record}")
                if train_shape:
                    bound, by = na_bwd_bound_ms(shape, q.element_size())

                    def plain_fwd_bwd():
                        leaves = [
                            t.detach().requires_grad_() for t in (q, kk, v)
                        ]
                        out = neighborhood_attention_2d(
                            *leaves, k, dil, weights_fn=weights_fn
                        )
                        return torch.autograd.grad(out, leaves, g)

                    record["ms"] = median_ms(
                        lambda: launch_na2d_bwd(
                            q, kk, v, g, k, dil, p, run_seed
                        )
                    )
                    record["plain_ms"] = median_ms(plain_fwd_bwd, iters=10)
                    record["bound_ms"] = bound
                    record["bound_by"] = by
                emit(record)
                records[name].append(record)
                del got, ref, leaves
            del q, kk, v, g
    torch.cuda.empty_cache()
    return {name: summarize(r, "bfloat16") for name, r in records.items()}


def train_setup(dropout: float):
    """The CLI-default model at full width (weights not yet drawn) and its
    CLI-default optimizer: AdamW, OneCycle peak 0.01 over 100 epochs of
    TRAIN_STEPS steps with the beta1 cycle, weight decay 1e-3, global-norm
    clip 1.0."""
    from cultionet_tpu_torch.models import CultioNet
    from cultionet_tpu_torch.train.optim import (
        build_momentum_schedule,
        build_optimizer,
        build_schedule,
    )

    model = CultioNet(
        in_time=12, in_channels=3, hidden_channels=64, dilations=[1, 2],
        dropout=dropout, activation_type="SiLU", attention_weights="natten",
    )
    tx = build_optimizer(
        optimizer="AdamW",
        learning_rate=build_schedule("OneCycleLR", 0.01, 100, TRAIN_STEPS),
        weight_decay=1e-3,
        eps=1e-4,
        gradient_clip_val=1.0,
        gradient_clip_algorithm="norm",
        b1_schedule=build_momentum_schedule("OneCycleLR", 100, TRAIN_STEPS),
    )
    return model, tx


def train_batch():
    from cultionet_tpu_torch.data.synthetic import create_batch

    return create_batch(
        num_channels=3, num_time=12, height=100, width=100, batch_size=4,
        rng=np.random.default_rng(0),
    )


def phase_train(smi: str):
    from cultionet_tpu_torch.train.step import (
        create_train_state,
        make_train_step,
    )

    model, tx = train_setup(dropout=0.2)
    state = create_train_state(model, tx, seed=0, device="cuda")
    step = make_train_step(
        loss_name="TanimotoComplementLoss", precision="16-mixed",
        device="cuda",
    )
    batch = train_batch().to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    losses = []
    for _ in range(TRAIN_WARMUP):
        state, logs = step(state, batch, gen)
        losses.append(logs["loss"])
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    start = time.perf_counter()
    for _ in range(TRAIN_STEPS - TRAIN_WARMUP):
        state, logs = step(state, batch, gen)
        losses.append(logs["loss"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = read_launches()
    losses = [float(x) for x in losses]
    timed = TRAIN_STEPS - TRAIN_WARMUP
    require(all(np.isfinite(losses)), f"train losses {losses}")
    require(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    want = {
        "na2d_fwd_drop": 3 * timed,
        "na2d_bwd_drop": 3 * timed,
        "na2d_fwd": 0,
        "na2d_bwd": 0,
    }
    require(launches == want, f"train launches {launches}, want {want}")
    emit(
        {
            "phase": "train",
            "card": smi,
            "batch": [4, 12, 100, 100, 3],
            "precision": "16-mixed",
            "dropout": 0.2,
            "loss_name": "TanimotoComplementLoss",
            "timed_steps": timed,
            "seconds": seconds,
            "steps_per_s": timed / seconds,
            "chips_per_s": 4 * timed / seconds,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
            "losses": losses,
            "launches": launches,
        }
    )
    return state, batch, launches, timed / seconds


def grad_diffs(got: dict, want: dict) -> T.Tuple[float, float]:
    """(largest max|got - want| over tensors relative to the largest entry
    of all of ``want``; largest over tensors of max|got - want| relative to
    that tensor's own largest entry, skipping all-zero tensors)."""
    top = max(ref.abs().max().item() for ref in want.values())
    worst_global = worst_own = 0.0
    for name, ref in want.items():
        diff = (got[name].cpu() - ref.cpu()).abs().max().item()
        worst_global = max(worst_global, diff / top)
        scale = ref.abs().max().item()
        if scale > 0:
            worst_own = max(worst_own, diff / scale)
    return worst_global, worst_own


def require_grads_close(label: str, got: dict, want: dict) -> dict:
    """Gradient limits: 1e-4 of the largest entry overall, 1e-2 of each
    tensor's own largest entry (a bias gradient sums a whole map of nearly
    cancelling terms, so its own scale can sit far below the rounding of
    its terms)."""
    rel_global, rel_own = grad_diffs(got, want)
    require(rel_global <= 1e-4, f"{label}: grads {rel_global} of the largest")
    require(rel_own <= 1e-2, f"{label}: grads {rel_own} of their own largest")
    return {
        "grad_rel_to_largest": rel_global,
        "grad_rel_to_own_largest": rel_own,
    }


def loss_and_grads(model, batch, device):
    from cultionet_tpu_torch.train.step import forward_loss

    model = model.to(device)
    gen = torch.Generator(device=device).manual_seed(0)
    loss, _ = forward_loss(
        model, batch.to(device), gen, torch.float32,
        loss_name="TanimotoComplementLoss",
    )
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    return loss.item(), grads


def phase_train_parity() -> dict:
    import copy

    from cultionet_tpu_torch.data.synthetic import create_batch
    from cultionet_tpu_torch.nn.init import init_parameters_
    from cultionet_tpu_torch.ops.flags import set_cuda_natten
    from cultionet_tpu_torch.train.step import (
        create_train_state,
        make_train_step,
    )

    model, tx = train_setup(dropout=0.0)
    init_parameters_(model, torch.Generator().manual_seed(1))
    batch = train_batch()

    # Path 3: one fp32 step at dropout 0 runs the no-dropout kernels.
    state = create_train_state(copy.deepcopy(model), tx, device="cuda")
    step = make_train_step(
        loss_name="TanimotoComplementLoss", precision="fp32", device="cuda"
    )
    gen = torch.Generator(device="cuda").manual_seed(0)
    zero_launches()
    state, logs = step(state, batch, gen)
    launches = read_launches()
    want = {
        "na2d_fwd": 3,
        "na2d_bwd": 3,
        "na2d_fwd_drop": 0,
        "na2d_bwd_drop": 0,
    }
    require(launches == want, f"parity launches {launches}, want {want}")
    require(np.isfinite(float(logs["loss"])), "parity step loss")
    del state

    kernel_loss, kernel_grads = loss_and_grads(
        copy.deepcopy(model), batch, "cuda"
    )
    set_cuda_natten(False)
    try:
        plain_loss, plain_grads = loss_and_grads(
            copy.deepcopy(model), batch, "cuda"
        )
    finally:
        set_cuda_natten(True)
    loss_err = abs(kernel_loss - plain_loss)
    require(loss_err <= 1e-5, f"parity: kernel vs plain loss {loss_err}")
    plain_diffs = require_grads_close(
        "kernel vs plain", kernel_grads, plain_grads
    )

    small = create_batch(
        num_channels=3, num_time=12, height=44, width=44, batch_size=2,
        rng=np.random.default_rng(1),
    )
    card_loss, card_grads = loss_and_grads(copy.deepcopy(model), small, "cuda")
    cpu_loss, cpu_grads = loss_and_grads(copy.deepcopy(model), small, "cpu")
    cpu_loss_err = abs(card_loss - cpu_loss)
    require(cpu_loss_err <= 1e-5, f"parity: card vs CPU loss {cpu_loss_err}")
    cpu_diffs = require_grads_close("card vs CPU", card_grads, cpu_grads)
    emit(
        {
            "phase": "train_parity",
            "precision": "fp32",
            "dropout": 0.0,
            "launches": launches,
            "kernel_vs_plain": {
                "batch": [4, 12, 100, 100, 3],
                "loss": kernel_loss,
                "loss_abs_diff": loss_err,
                **plain_diffs,
            },
            "card_vs_cpu": {
                "batch": [2, 12, 44, 44, 3],
                "loss_abs_diff": cpu_loss_err,
                **cpu_diffs,
            },
            "limits": {"loss": 1e-5, "grad_rel_to_largest": 1e-4,
                       "grad_rel_to_own_largest": 1e-2},
        }
    )
    torch.cuda.empty_cache()
    return launches


def phase_eval(state, batch) -> None:
    from cultionet_tpu_torch.train.step import make_eval_step

    eval_step = make_eval_step(
        loss_name="TanimotoComplementLoss", precision="16-mixed",
        device="cuda",
    )
    metrics = {k: float(v) for k, v in eval_step(state, batch).items()}
    for name, value in metrics.items():
        require(np.isfinite(value), f"eval {name} = {value}")
    for name in ("edge_f1", "crop_f1"):
        require(0.0 <= metrics[name] <= 1.0, f"eval {name} {metrics[name]}")
    for name in ("edge_mcc", "crop_mcc"):
        require(-1.0 <= metrics[name] <= 1.0, f"eval {name} {metrics[name]}")
    emit({"phase": "eval", "precision": "16-mixed", **metrics})


def phase_train_profile(state, batch, steps_per_s: float) -> None:
    from torch.profiler import ProfilerActivity, profile

    from cultionet_tpu_torch.train.step import make_train_step

    step = make_train_step(
        loss_name="TanimotoComplementLoss", precision="16-mixed",
        device="cuda",
    )
    gen = torch.Generator(device="cuda").manual_seed(5)
    step(state, batch, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(state, batch, gen)
        torch.cuda.synchronize()
    events, total_us, top = device_time_by_kernel(prof, 12)
    # A second step profiled on the host alone: where the idle share goes.
    with profile(activities=[ProfilerActivity.CPU]) as host_prof:
        step(state, batch, gen)
        torch.cuda.synchronize()
    host = sorted(
        host_prof.key_averages(), key=lambda e: -e.self_cpu_time_total
    )
    na = {
        name: sum(
            e.device_time_total for e in events if f"{name}_kernel" in e.key
        )
        / 1e3
        for name in ("na2d_fwd", "na2d_bwd_query", "na2d_bwd_key")
    }
    emit(
        {
            "phase": "train_profile",
            "batch": [4, 12, 100, 100, 3],
            "precision": "16-mixed",
            "device_ms": total_us / 1e3,
            # Against the host-timed step of phase train, same run.
            "device_idle_share": 1.0 - total_us / 1e6 * steps_per_s,
            "na_kernels_ms": na,
            "na_share": sum(na.values()) * 1e3 / total_us
            if total_us
            else None,
            "top": top,
            "host_self_ms": sum(e.self_cpu_time_total for e in host) / 1e3,
            "host_ops": sum(e.count for e in host),
            "host_top": [
                {
                    "op": e.key[:60],
                    "self_ms": e.self_cpu_time_total / 1e3,
                    "calls": e.count,
                }
                for e in host[:10]
            ],
        }
    )


def kernel_entry(name, source, replaces, launches, summary) -> dict:
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": summary["max_abs_err"],
        "ms": summary["ms"],
        "plain_ms": summary["plain_ms"],
        "bound_ms": summary["bound_ms"],
        "bound_by": summary["bound_by"],
        "library_ms": None,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = phase_device()
    phase_build()
    fwd = phase_kernels()
    fwd_drop = phase_fwd_drop()
    bwd = phase_bwd()
    model = build_model()
    phase_model(model)
    predict_launches = phase_predict(model)
    phase_profile(model)
    del model
    torch.cuda.empty_cache()
    state, batch, train_launches, steps_per_s = phase_train(smi)
    parity_launches = phase_train_parity()
    phase_eval(state, batch)
    phase_train_profile(state, batch, steps_per_s)

    fwd_src = "cultionet_tpu_torch/ops/csrc/na2d_fwd.cu"
    bwd_src = "cultionet_tpu_torch/ops/csrc/na2d_bwd.cu"
    pallas = "cultionet_tpu/ops/natten_pallas.py"
    emit(
        {
            "kernels": [
                kernel_entry(
                    "na2d_fwd", fwd_src, f"{pallas}:453",
                    predict_launches["na2d_fwd"], fwd,
                ),
                kernel_entry(
                    "na2d_fwd_drop", fwd_src, f"{pallas}:462",
                    train_launches["na2d_fwd_drop"], fwd_drop,
                ),
                kernel_entry(
                    "na2d_bwd", bwd_src, f"{pallas}:612",
                    parity_launches["na2d_bwd"], bwd["na2d_bwd"],
                ),
                kernel_entry(
                    "na2d_bwd_drop", bwd_src, f"{pallas}:624",
                    train_launches["na2d_bwd_drop"], bwd["na2d_bwd_drop"],
                ),
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
