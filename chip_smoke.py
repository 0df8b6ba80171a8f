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
   shapes and larger kernel sizes; device times (below) beside the bound,
   the share of the bound and the plain version's time; the tile plan
   each launch ran.
4. kernel_check na2d_fwd_drop: the dropout forward at the train path's
   shapes: at p = 0 equal to na2d_fwd bit for bit; at p = 0.2 against the
   plain version given ``dropout_keep_mask`` of the same seed (same
   limits); its keep rate (read from the kernel's output) within
   0.8 +- 0.002; two seeds, two masks.
5. kernel_check na2d_bwd / na2d_bwd_drop: dq, dk, dv against autograd of
   the plain version (with the same mask for the dropout variant) at the
   train shapes and the ragged and k = 5/7 shapes (fp32 <= 1e-4; bf16
   <= 5e-2 against the fp32 plain version on the same bf16 inputs); two
   launches on the same inputs give equal bits; times beside the bound
   and the plain version's forward + backward.
6. kernel_check temporal_fwd / temporal_bwd: the temporal-attention
   kernels against the plain version (backward: against its autograd) at
   the transformer's calls on the two main paths (a layer, T = 12 x 12,
   and the pooling, 1 x 12 with the query broadcast over the pixels, at
   8 x 140^2 and 4 x 100^2 pixels), a ragged N, head_dim 2 at T = 13, 3
   heads of 32, T = 24, 600 query steps over 4 keys (one pixel a tile;
   backward in fp32 only), head_dim 64, rows not 16-byte aligned (C = 30)
   and a pooling call with a ragged last tile; same limits as the NA
   kernels; two backward launches give equal bits; the tile plan of each
   launch; times beside the bound, the plain version's and torch's
   scaled_dot_product_attention's (the yardstick).
   kernel_check layer_norm_rows: the LayerNorm kernel
   (``ops/layer_norm_cuda.py``, no TPU counterpart) against
   ``F.layer_norm`` on the same inputs at the transformer's predict calls
   (156,800 x 12 x 64 five times a forward, 156,800 x 64, 1 x 1 x 64), a
   ragged row count and widths 24, 256 and 1024, 36 and 4 (8-byte loads in
   bf16), 5 (scalar loads) (fp32 <= 1e-5; bf16 within one bf16 ulp of the
   output's largest magnitude); the launch plan the library chose;
   device times beside the byte bound and ``F.layer_norm``'s (the plain
   version and the yardstick: one call computes the same function).
7. kernel_check na_block_fwd: the fused NA block kernel (#7, one launch
   over coset tiles) against its plain version
   (``ops/na_block.py::na_block_plain``) at the decoder's three NA sites
   (B=8, C=256: 35^2 h8, 70^2 h4, 140^2 h4 d2) and at a ragged 37x35,
   k = 1, C = 64 with 4 heads, B = 1 and C = 40 (padded channels): bf16
   <= 2e-2 against the plain version in fp32 on the same bf16 inputs;
   fp32 <= 2e-2 with at most 10% of the outputs above 1e-4 (the block
   rounds intermediates to bf16; see ``phase_na_block_fwd``); the public
   wrapper equal to the launch bit for bit; the tile plan of each launch;
   times (``ms`` the launch on weights laid out once, ``prep_ms`` that
   layout) beside the bound, the plain version's and the port's unfused
   composition's (LayerNorm, linear, NA kernel #1, linear, LayerNorm: no
   single PyTorch call computes the block); then na_block_fwd_profile:
   one kernel in the profile of a launch at 140^2 d2, with its registers
   and spills (ptxas).
8. na_block_grad: ``fused_na_block`` forward and backward in fp32 at the
   three train sites (B=4: 25^2, 50^2, 100^2 d2): the gradients of x and
   of the eight parameters within 1e-5 of the largest entry of autograd of
   ``na_block_reference`` on the card; one na_block_fwd launch per
   forward, and the backward's na2d_fwd and na2d_bwd launches counted.
9. model / model_transformer: the full-width CLI-default CultioNet
   (hidden 64, T=12, 140-px windows, B=8, seeded weights, BatchNorm
   statistics estimated by training-mode passes), with the conv and with
   the transformer temporal front end, with the kernels and with the
   kernel under test switched to its plain version (fp32, <= 1e-4), and
   against the CPU on a small input.
10. predict / predict_transformer (main paths): ScenePredictor.predict_scene
    at bf16 on a seeded int16 scene (T=12, 420x420, C=3, window 100,
    padding 20: 25 windows in 4 batches of 8): 12 launches of na2d_fwd
    (and of temporal_fwd for the transformer), no others; 28 launches of
    the LayerNorm kernel for the transformer (7 a batch), none for the conv.
11. forward_profile(_transformer): device time by kernel for one bf16
    window batch; with the transformer also layernorm_bounds: the
    LayerNorm calls (PyTorch's ``aten::layer_norm`` and the port's
    ``cultionet_tpu_torch::layer_norm_rows``) by input shape
    (record_shapes), dtype and contiguity, their device time beside a byte
    bound (rows x C read and written once).
12. train / train_transformer (main paths): the CLI-default train step
    (hidden 64, dropout 0.2, TanimotoComplementLoss, AdamW + OneCycle +
    global-norm clip 1.0, "16-mixed") on one fixed seeded batch of 4
    chips of 100x100, T=12, 3 bands: 3 warm-up steps, then 20 timed steps.
    Every loss finite, the last below the first, exactly 3 launches of
    na2d_fwd_drop and of na2d_bwd_drop per step (and 3 of temporal_fwd
    and temporal_bwd for the transformer) and no others: no LayerNorm
    kernel under a gradient.
13. train_parity(_transformer) (dropout 0): one fp32 step launches
    na2d_fwd and na2d_bwd 3 times each (and the temporal kernels 3 times
    each for the transformer); its loss and gradients with the kernels
    against the plain version, and on the card against the CPU.
14. eval: make_eval_step at bf16 on the trained conv state: finite
    metrics, F-scores in [0, 1], MCC in [-1, 1].
15. train_profile(_transformer): device time by kernel for one bf16 train
    step (each NA kernel, na2d_fwd_kernel, na2d_bwd_query_kernel and
    na2d_bwd_key_kernel, must show), and host time by operator for another
    (the profiler's own overhead included).
16. fit (main path of the fit slice): 20 seeded int16 chip files (100x100,
    T=12, 3 bands, labels, boundary distances) in a temporary directory,
    their NormValues, then ``model.fit`` with the CLI's training defaults
    for 2 epochs with checkpoints (16 train and 4 validation chips, 4
    steps an epoch), then ``epochs=3`` on the same checkpoint. Every loss
    finite; history 2 rows, then 3; the resumed run starts at epoch 2 from
    step 8; the restored parameters, BatchNorm statistics and optimizer
    state equal the saved ones bit for bit; ``last`` and ``best`` exist;
    per train step 3 na2d_fwd_drop and 3 na2d_bwd_drop, per validation
    batch 3 na2d_fwd, nothing else; ``load_model(best)`` through
    ScenePredictor on the 420x420 scene: finite, 12 na2d_fwd launches.
    Host-timed train chips/s of one epoch beside the bare step's, and the
    resumed run's device idle share.
17. fit_augment (the CLI default, host augmentation at augment_prob 0.5):
    the same 20 chips, 2 epochs then a resume to 3; every loss finite;
    launches as in fit (augmentation is host work and launches nothing);
    ``last`` and ``best`` written. Host-timed train chips/s of one epoch
    beside fit's at 0.0; the loader alone over the 2-epoch run's loading
    with augmentation off and on, in turns; the crop parcels of the
    chips; each augmenter's median host ms a sample over 21 samples on a
    100x100, T=12, 3-band chip with a field layout.
18. predict_raster (the predict half of the CLI default from files): the
    fit phase's ``best`` checkpoint; the seeded 420x420 int16 scene ->
    ``create_predict_dataset`` (window 100, padding 20: 25 chips) ->
    ``ChipDataset`` -> ``predict_windows`` and ``predict_to_raster`` at
    bf16, batch 8: 12 na2d_fwd launches each and nothing else; the TIFF
    read back band by band equal to the ``.npz`` sidecar's raster, its
    bounds, cell size and CRS and the sidecar's transform as written; the
    chip-file raster at fp32 within 1e-4 max-abs of ``predict_scene`` on
    the same float scene. Windows/s and the raster write's seconds.
19. export (the serving export, the main path of the serving slice):
    ``export_predictor`` of the fit phase's best checkpoint and
    ``export_state`` of the seeded full-width transformer model, at batch
    8 of 140-px windows, in bf16 and fp32; a fresh process loads the four
    artifacts with ``load_predictor`` alone (no module of the port's
    ``models`` or ``nn`` imported), each call launching 3 na2d_fwd (and 3
    temporal_fwd and 7 layer_norm_rows with the transformer) and nothing
    else, its graph naming the registered ops as often; its rasters on a seeded int16 batch equal to the
    in-process predict step's within 1e-5 (fp32) and 2e-2 (bf16), both
    with cuDNN's deterministic algorithms (with its defaults two calls of
    the fp32 step differ by up to about 1e-5, recorded). Served chips/s of
    ``call_on_device`` beside the in-process step's, export seconds and
    artifact bytes.
20. transfer (the rest of single-card train): ``fit_transfer`` from the
    fit's store for 1 epoch with ``finetune`` None and "fc" (the backbone
    bit for bit, the heads and BatchNorm statistics moved, the launches of
    ``fit``), a 20-step ``lr_find`` (rising learning rates, a suggestion
    or a divergence, 3 na2d_fwd_drop and 3 na2d_bwd_drop a step), a
    1-epoch fit with ``model_pruning`` (each pruned tensor at least 20%
    zeros) and a 1-epoch RAdam fit (finite losses).
21. cli (the command line, the main path of the CLI slice): a seeded
    project of 20 regions (scene.npz of 12 x 100 x 100 x 3 int16 and a
    polygons.json field layout of 16-25 jittered fields, some concave,
    some with a hole, the outer ones past the scene's edge) and one 420 x
    420 region, driven in-process through ``scripts/cli.py::main`` at the
    CLI defaults: ``create`` (20 chips, each chip's crop parcels equal to
    its fields), ``train --skip-train`` (the normalization statistics and
    the model build, no launch), ``train --epochs 2`` then a resume to 3
    (the launches of ``fit``: per train step 3 na2d_fwd_drop and 3
    na2d_bwd_drop, per validation batch 3 na2d_fwd), ``last``/``best``
    and a finite history,
    ``create-predict --window-size 100 --padding 20`` (25 chips),
    ``predict`` to a GeoTIFF (12 na2d_fwd; the TIFF equal to its sidecar,
    the scene's bounds, transform and CRS; bit for bit the raster of
    ``predict_to_raster`` through the API on the same checkpoint and
    chips), ``train-transfer`` for 1 epoch (the launches of ``fit``),
    ``export`` (bf16, batch 8, 140-px windows) with the region's window
    chips served through the artifact (the blended raster within 2e-2 of
    ``predict``'s), ``train --spatial-partitions FILE --partition-name
    east`` on a copy of the chips (10 train, 10 validation chips), then
    ``python -m cultionet_tpu_torch version`` in a subprocess. Create s
    per chip, the fit's epoch and train chips/s; the 2-epoch fit from
    scratch through ``model.fit`` (the same training
    defaults and launches) at augment_prob 0.0 and 0.5 in turns, and the
    loader alone over the 2-epoch fit's loading at augment_prob 0.0 and
    0.5 in turns, windows/s and the raster write's seconds.
22. model_options (the model options off the CLI default, each at full
    width with seeded weights): the CLI default (first and last: the
    host's pace drifts over a run; rates are given over their mean; the
    second run trains only) and O1
    ``res`` + spatial_channel, O2 ``res`` + none, O3 ``resa`` +
    spatial_channel, O4 pool_by_max, O5 batchnorm_first, O6 use_latlon
    and O7 remat (O4-O7 with NATTEN). For each: 2 warm-up and 10 timed
    "16-mixed" train steps on 4 x 100^2 x T12 x 3 (chips/s; device ms of
    one profiled step and the idle share; for the default and O6 also
    with cuDNN's TF32, PyTorch's default), one bf16 predict batch of 8 x
    140^2 windows on a seeded model whose BatchNorm statistics 20
    training-mode passes estimate (windows/s), the exact NA launches
    (none for O1-O3; per step 3 na2d_fwd_drop and 3 na2d_bwd_drop, 6
    and 3 under remat,
    whose recompute runs the forward kernel again; 3 na2d_fwd a predict
    batch), the predict forward with the kernels against
    ``set_cuda_natten(False)`` (fp32 <= 1e-4; bf16 within 2e-2 of the
    fp32 plain forward beyond the bf16 plain forward's own distance from
    it) and an fp32 dropout-0
    step at batch 1 (1 x 44^2) on the card against the CPU (the limits of
    train_parity). O7 also: the remat step against the plain step in
    fp32 at dropout 0.2 from one generator seed with cuDNN's
    deterministic algorithms (loss, gradients and running statistics
    within 1e-5, the generator's state equal), and the peak memory of a
    step with and without remat at batch 4 and 16. O6 also: a bf16
    artifact of batch 8 x 140^2 through ``export_state``, served in
    process equal (0.0) to the eager serve program, two coordinate
    batches giving different outputs. Then ``train --pool-by-max
    --batchnorm-first --use-latlon --epochs 1`` and ``predict`` on a copy
    of the cli phase's project: the launches of a 1-epoch ``fit``, 12
    na2d_fwd, the raster written. Each configuration's seconds.

23. device_data (the device data path, ``--use-chipstore`` and
    ``--device-augment``): a project of 40 field-layout regions (as cli's)
    through ``create``, 32 train and 8 validation chips, their
    normalization statistics. The chipstore library built with g++ (timed);
    a v2 store of the train chips whose ``read_batch`` equals the chips'
    int16 records bit for bit; one epoch of ``ChipstoreLoader`` on the card
    (4 threads, page-locked ring): every chip once, each batch equal to its
    chips' records; the same epoch copied synchronously from pageable
    memory, for the time. ``DeviceChipCache`` on the card: upload seconds,
    ``resident_bytes`` against ``estimate_cache_bytes``, device memory
    before and after, ``gather_batch`` equal to the records. The 8
    dihedral codes on the card equal to the CPU bit for bit on a CLI-size
    batch; 4,096 draws on the card: the codes' chi-square p > 1e-3, the
    noise's mean within 3 sigma / sqrt(n) of 0 and std within 2%. fp32 at
    dropout 0 (cuDNN deterministic) on 2 chips: the in-step step
    (norm_stats) against the host path's step on the same records (loss within 1e-5 relative,
    gradients within train_parity's limits), the hbm step against the
    in-step step (bit for bit). Then ``fit`` (the CLI's training defaults)
    for 2 epochs in each of: the host loader at augment_prob 0 and 0.5,
    "stream", "hbm", and "hbm" with ``device_augment`` and noise 0.01:
    per train step 3 na2d_fwd_drop and 3 na2d_bwd_drop, per validation
    batch 3 na2d_fwd, nothing else; each epoch's train loop seconds
    (train chips/s from the second), two steps of the first under the
    profiler (device ms, idle share); the loader alone for an epoch and
    one checkpoint save. A resumed "hbm" fit (in-step augmentation,
    exponential decay; 1 epoch and a resume to 2) equal to an
    uninterrupted 2-epoch one bit for bit; "hbm" with ``use_latlon``
    raising before any launch;
    ``train --use-chipstore auto --device-augment --epochs 1`` on the
    project: the resident split chosen and its size logged, the launches
    of a 1-epoch fit.
24. data_parallel (``parallel/``, the port's data-parallel path, on the
    one card; fp32, TF32 off, cuDNN deterministic, the CLI chip size):
    (b) two ranks on the card over gloo (NCCL refuses two ranks on one
    device) with CUDA tensors, each its block of 4 of a seeded batch of 8
    chips: the sharded dropout-0 step's loss, parameters and the gradients
    its optimizer receives against the single-process step on all 8 (loss
    rtol 1e-5, parameters within 1e-5, gradients as ``require_grads_close``
    holds them: Adam and the clip hide a factor common to every
    gradient), 3 na2d_fwd and 3 na2d_bwd per rank; FSDP2
    (``fsdp_min_size`` 2**16) on the two ranks, held the same way, its
    sharded submodules named (a
    refusal is printed on its own line and fails the phase); the
    CLI-default "16-mixed" sharded step at dropout 0.2, 3 warm-up and 10
    timed steps per rank: 3 na2d_fwd_drop and 3 na2d_bwd_drop per step
    per rank, the step's ms and the gradient all-reduce's share of it.
    (a) an NCCL group of one in this process: a 1-epoch ``fit`` (the fit
    phase's chips and training defaults in fp32) through the sharded step
    equal bit for bit to the same fit without a group (history, weights,
    statistics, optimizer state), per train step 3 na2d_fwd_drop and 3
    na2d_bwd_drop, per validation batch 3 na2d_fwd. (c) FSDP2 at world
    size 1 in that group: one dropout-0 fp32 step against the plain step
    (parameters within 1e-6, gradients as in (b)). (d) ``ScenePredictor`` through its multi-device split
    (one replica) equal bit for bit to today's single-device predict, 12
    na2d_fwd; ``devices=2`` refused on a machine of one card.
25. import_torch (the reference checkpoint importer, ``import-torch``):
    the CLI-default CultioNet (hidden 64) with weights from a seeded
    generator (BatchNorm running variances in [1, 2]) written as a
    Lightning ``last.ckpt`` in reference names
    (``tests/torch_reference_keys.py``) with its ``hyper_parameters``;
    ``python -m cultionet_tpu_torch import-torch`` on it in a subprocess
    on the card (the entries imported and the command's seconds, with the
    card's name and power limit, on a line of their own); the same
    checkpoint with one entry's shape changed (its command run beside the
    import) makes the command exit non-zero naming that entry. ``load_model`` of the store then predicts
    the predict phase's seeded 420^2 scene (25 windows of 140^2, batches
    of 8) through ``ScenePredictor``, in fp32 (TF32 off, cuDNN
    deterministic) and in bf16: each raster equal bit for bit to the
    source model's, and 3 na2d_fwd per batch. The cli phase (21) also
    prints the seconds of a chip's orientation (the Sobel and the phase
    of ``create``'s boundary distances).

Kernel times (``ms``, ``library_ms``) are device times: ``device_ms``
queues 20 calls behind a sleep kernel so the card runs them back to back
and the host's dispatch is hidden; ``call_ms`` (NA kernels) and
``plain_ms`` time single calls with CUDA events (``median_ms``), host
dispatch included where the card is faster than the host.

Kernel launch counts are zeroed just before each path (8, 10, 12, 13,
16-18, 20-25; the serving process of 19 and the ranks of 24 zero their
own) and read just after. Then the kernels line (seven kernels), and last
``{"ok": true, "device": {...}}``. TF32 is off for matmuls and
convolutions throughout, so fp32 comparisons hold fp32 arithmetic.
"""

import contextlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
import typing as T
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

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


def device_ms(fn, launches: int = 20, reps: int = 5) -> float:
    """Device time of one call of ``fn``: ``launches`` calls queued behind
    ``torch.cuda._sleep``, long enough for the host to queue them all, so
    the card runs them back to back and the host's dispatch is hidden (the
    card's gaps between kernels stay in); the median over ``reps``.
    ``median_ms`` times single calls, host dispatch included where the
    card is faster than the host."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(launches):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - start
    times = []
    for _ in range(reps):
        # 4e9 cycles a second: at least twice the queueing time at the
        # H100's clock (under 2 GHz).
        torch.cuda._sleep(int(host_s * 4e9) + 10_000)
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        begin.record()
        for _ in range(launches):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(begin.elapsed_time(end) / launches)
    return statistics.median(times)


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


def _launch_counters() -> tuple:
    from cultionet_tpu_torch.ops import flags

    return flags.launch_tables()


def zero_launches() -> None:
    torch.cuda.synchronize()
    for counter in _launch_counters():
        for name in counter:
            counter[name] = 0


def read_launches() -> dict:
    torch.cuda.synchronize()
    return {
        name: count
        for counter in _launch_counters()
        for name, count in counter.items()
    }


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


def tile_plans(passes, *tensors) -> dict:
    """The tile plan of each pass (name -> (kernel_size, dilation)) of a
    launch on ``tensors`` (``natten_cuda._tile_plan``), with the elements
    per load."""
    import dataclasses

    from cultionet_tpu_torch.ops import natten_cuda

    _, h, w, _, d = tensors[0].shape
    vec = natten_cuda._vector_width(d, *tensors)
    return {"vec": vec} | {
        p: dataclasses.asdict(
            natten_cuda._tile_plan(
                h, w, *passes[p], d, tensors[0].element_size(), p, vec
            )
        )
        for p in passes
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


def ptxas_report(log: str) -> list:
    """nvcc's ``-Xptxas -v`` report as one entry per kernel: its name (by
    ``c++filt`` where the machine has it), registers, stack frame (local
    arrays and spills) and spill stores and loads in bytes."""
    import re

    entries, name, frame = [], None, (0, 0, 0)
    for line in log.splitlines():
        found = re.search(r"Function properties for (\S+)", line)
        if found:
            name = found.group(1)
        found = re.search(
            r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes "
            r"spill", line
        )
        if found:
            frame = tuple(int(g) for g in found.groups())
        found = re.search(r"Used (\d+) registers", line)
        if found and name:
            entries.append([name, int(found.group(1)), *frame])
            name, frame = None, (0, 0, 0)
    try:
        names = subprocess.run(
            ["c++filt"], input="\n".join(e[0] for e in entries),
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = [e[0] for e in entries]
    if len(names) != len(entries):
        names = [e[0] for e in entries]
    return [
        {
            "kernel": full.replace("(anonymous namespace)::", "")
            .removeprefix("void ").split("(")[0],
            "registers": regs,
            "stack_frame": stack,
            "spill_stores": stores,
            "spill_loads": loads,
        }
        for full, (_, regs, stack, stores, loads) in zip(names, entries)
    ]


def phase_build() -> None:
    from cultionet_tpu_torch.ops import build, flags

    flags.launch_tables()  # imports each kernel module, which registers its library
    names = list(build.LIBRARIES)
    start = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        futures = {
            name: pool.submit(build.compile_library, name)
            for name in names
        }
        reports = {name: f.result() for name, f in futures.items()}
    seconds = time.perf_counter() - start
    for name in names:
        build.load_library(name)
    for name, (path, log) in reports.items():
        emit(
            {
                "phase": "build",
                "kernel": name,
                "library": str(path.name),
                "ptxas": ptxas_report(log),
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
                record["ms"] = device_ms(lambda: na2d_cuda(q, kk, v, k, d))
                record["call_ms"] = median_ms(
                    lambda: na2d_cuda(q, kk, v, k, d)
                )
                record["plain_ms"] = median_ms(
                    lambda: neighborhood_attention_2d(q, kk, v, k, d),
                    iters=10,
                )
                record["bound_ms"] = bound
                record["bound_by"] = by
                record["share_of_bound"] = bound / record["ms"]
            record["plan"] = tile_plans({"fwd": (k, d)}, q, kk, v)
            emit(record)
            records.append(record)
            del q, kk, v, out, ref
    torch.cuda.empty_cache()
    return summarize(records, "bfloat16")  # the predict path's dtype


def cli_model(temporal_encoder: str = "conv", dropout: float = 0.2):
    """The CLI-default model at full width (weights not yet drawn), with
    the conv or the transformer temporal front end."""
    from cultionet_tpu_torch.models import CultioNet

    return CultioNet(
        in_time=12, in_channels=3, hidden_channels=64, dilations=[1, 2],
        dropout=dropout, activation_type="SiLU", attention_weights="natten",
        temporal_encoder=temporal_encoder,
    )


def build_model(temporal_encoder: str = "conv"):
    """The CLI-default model with seeded weights, on the card, in eval
    mode, its BatchNorm running statistics estimated by 20 training-mode
    passes over seeded random windows, as a trained model's are. Left at
    their initial values, the random network amplifies fp32 round-off
    about 30 times more (fp32 against fp64 outputs: 6.2e-5 against 2.0e-6
    on a 2 x 44 x 44 input, on the CPU), which the model phase's fp32
    comparisons would read as kernel error."""
    from cultionet_tpu_torch.nn.dropout import dropout_rng
    from cultionet_tpu_torch.nn.init import init_parameters_

    model = cli_model(temporal_encoder)
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


def plain_switch(temporal_encoder: str):
    """The switch that sends the path's kernel-under-test to its plain
    version: the NA kernels for the conv model, the temporal kernels for
    the transformer model (its NA kernels stay on)."""
    from cultionet_tpu_torch.ops import flags

    if temporal_encoder == "transformer":
        return flags.set_cuda_temporal
    return flags.set_cuda_natten


def forward_launches(temporal_encoder: str) -> dict:
    """Kernel launches of one eval forward; the transformer's LayerNorm
    kernel seven times (two a layer, the pooling keys and query, the
    embedding)."""
    want = {name: 0 for name in read_launches()}
    want["na2d_fwd"] = 3
    if temporal_encoder == "transformer":
        want["temporal_fwd"] = 3
        want["layer_norm_rows"] = 7
    return want


def phase_model(model, temporal_encoder: str = "conv") -> None:
    phase = "model" if temporal_encoder == "conv" else "model_transformer"
    switch = plain_switch(temporal_encoder)
    gpu_model = model.to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.rand(8, 12, 140, 140, 3, device="cuda", generator=gen)
    with torch.inference_mode():
        zero_launches()
        kernel_out = gpu_model(x)
        launches = read_launches()
        switch(False)
        try:
            plain_out = gpu_model(x)
        finally:
            switch(True)
        forward_ms = median_ms(lambda: gpu_model(x), iters=5, warmup=1)
    check_outputs(kernel_out, (8, 140, 140, 1), phase)
    check_outputs(plain_out, (8, 140, 140, 1), f"{phase} (plain)")
    want = forward_launches(temporal_encoder)
    require(launches == want, f"{phase} forward launched {launches}")
    err = max(
        (kernel_out[n] - plain_out[n]).abs().max().item()
        for n in ("distance", "edge", "crop")
    )
    require(err <= 1e-4, f"{phase}: kernel vs plain max-abs {err}")
    emit(
        {
            "phase": phase,
            "input": [8, 12, 140, 140, 3],
            "dtype": "float32",
            "launches": launches,
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
    require(err <= 1e-4, f"{phase}: card vs CPU max-abs {err}")
    emit(
        {"phase": f"{phase}_vs_cpu", "input": [1, 12, 44, 44, 3], "max_abs": err}
    )


def phase_predict(model, temporal_encoder: str = "conv") -> dict:
    from cultionet_tpu_torch.predict import ScenePredictor

    phase = "predict" if temporal_encoder == "conv" else "predict_transformer"
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
    windows, batches = 25, 4
    want = {k: batches * n for k, n in forward_launches(temporal_encoder).items()}
    require(launches == want, f"{phase} launched {launches}, want {want}")
    emit(
        {
            "phase": phase,
            "scene": [12, 420, 420, 3],
            "windows": windows,
            "batches": batches,
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


LAYERNORM_OPS = ("aten::layer_norm", "cultionet_tpu_torch::layer_norm_rows")


def layernorm_bounds(run, x) -> None:
    """The LayerNorm calls in one forward of ``run`` (PyTorch's and the
    port's op, ``LAYERNORM_OPS``): per op and input shape (the profiler's
    ``record_shapes``), its calls, device time and byte bound (rows x C
    read and written once in the input's dtype over the HBM rate), with
    the dtype and contiguity a forward pre-hook saw on ``nn.LayerNorm``
    modules (the port's op takes the model's dtype, contiguous rows)."""
    import math

    from torch.profiler import ProfilerActivity, profile

    seen = {}

    def hook(module, args):
        t = args[0]
        seen[tuple(t.shape)] = (str(t.dtype).replace("torch.", ""),
                                t.is_contiguous(), t.element_size())

    hooks = [
        m.register_forward_pre_hook(hook)
        for m in run.modules() if isinstance(m, torch.nn.LayerNorm)
    ]
    try:
        with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            record_shapes=True,
        ) as prof:
            run(x)
            torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    model_dtype = (str(x.dtype).replace("torch.", ""), True, x.element_size())
    rows = []
    for e in prof.key_averages(group_by_input_shape=True):
        if e.key not in LAYERNORM_OPS or not e.input_shapes:
            continue
        shape = tuple(e.input_shapes[0])
        if e.key == LAYERNORM_OPS[0]:
            dtype, contiguous, itemsize = seen.get(shape, ("unknown", None, 2))
        else:
            dtype, contiguous, itemsize = model_dtype
        per_call = math.prod(shape) * itemsize * 2 / HBM_BYTES_PER_S * 1e3
        ms = e.device_time_total / 1e3
        rows.append({
            "op": e.key, "shape": list(shape), "dtype": dtype,
            "contiguous": contiguous, "calls": e.count, "device_ms": ms,
            "bound_ms": per_call * e.count,
        })
    emit({
        "phase": "layernorm_bounds",
        "rows": rows,
        "device_ms": sum(r["device_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows),
        "calls": sum(r["calls"] for r in rows),
    })


def phase_profile(model, temporal_encoder: str = "conv") -> None:
    from torch.profiler import ProfilerActivity, profile

    phase = "forward_profile"
    if temporal_encoder != "conv":
        phase = "forward_profile_transformer"
    run = model.to("cuda", torch.bfloat16)
    x = torch.rand(8, 12, 140, 140, 3, device="cuda").to(torch.bfloat16)
    with torch.inference_mode():
        run(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run(x)
            torch.cuda.synchronize()
    events, total_us, top = device_time_by_kernel(prof, 8)
    kernels_ms = {
        name: sum(e.device_time_total for e in events if name in e.key) / 1e3
        for name in ("na2d_fwd", "temporal_fwd")
    }
    if temporal_encoder != "conv":
        layernorm_bounds(run, x)
    emit(
        {
            "phase": phase,
            "input": [8, 12, 140, 140, 3],
            "dtype": "bfloat16",
            "device_ms": total_us / 1e3,
            "kernels_ms": kernels_ms,
            "na2d_fwd_share": kernels_ms["na2d_fwd"] * 1e3 / total_us
            if total_us
            else None,
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
            record["ms"] = device_ms(
                lambda: launch_na2d_fwd(q, kk, v, k, dil, p, seed)
            )
            record["call_ms"] = median_ms(
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
            record["share_of_bound"] = bound / record["ms"]
            record["plan"] = tile_plans({"fwd": (k, dil)}, q, kk, v)
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
                again = launch_na2d_bwd(q, kk, v, g, k, dil, p, run_seed)
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
                require(
                    all(torch.equal(a, b) for a, b in zip(got, again)),
                    f"two launches differ: {record}",
                )
                record["plan"] = tile_plans(
                    {"bwd_query": (k, dil), "bwd_key": (k, dil)}, q, kk, v, g
                )
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

                    def kernel():
                        return launch_na2d_bwd(
                            q, kk, v, g, k, dil, p, run_seed
                        )

                    record["ms"] = device_ms(kernel)
                    record["call_ms"] = median_ms(kernel)
                    record["plain_ms"] = median_ms(plain_fwd_bwd, iters=10)
                    record["bound_ms"] = bound
                    record["bound_by"] = by
                    record["share_of_bound"] = bound / record["ms"]
                emit(record)
                records[name].append(record)
                del got, again, ref, leaves
            del q, kk, v, g
    torch.cuda.empty_cache()
    return {name: summarize(r, "bfloat16") for name, r in records.items()}


TEMPORAL_ROWS = [  # (label, N, Tq, S, C, heads): #5/#6 calls on the main paths
    ("predict_layer", 8 * 140 * 140, 12, 12, 64, 4),
    ("predict_pool", 8 * 140 * 140, 1, 12, 64, 4),
    ("train_layer", 4 * 100 * 100, 12, 12, 64, 4),
    ("train_pool", 4 * 100 * 100, 1, 12, 64, 4),
]
TEMPORAL_EXTRA = [  # ragged N, the golden model's head_dim 2 at T = 13, 3 heads, T = 24, ...
    ("ragged", 37 * 41, 12, 12, 64, 4),
    ("hd2_t13", 2 * 70 * 70, 13, 13, 8, 4),
    ("heads3", 3000, 12, 12, 96, 3),
    ("t24", 3000, 24, 24, 64, 4),
    ("t24_pool", 3000, 1, 24, 64, 4),
    # A pixel's tile (600 query rows and their statistics) fills most of a
    # block's shared memory: one pixel a tile, one copy stage in the
    # backward. Its gradients sum 600 steps to magnitudes near 30, where
    # bf16's rounding of the output alone passes the bf16 limit: the
    # backward checks it in fp32 only.
    ("long_query", 40, 600, 4, 16, 8),
    # head_dim 64 (four 16-wide MMA steps), rows that are not 16-byte
    # aligned (C = 30: the kernels' element-wise copies, head_dim 10 read
    # with zero-padded fragments), and a pooling call whose N is not a
    # multiple of its tile.
    ("hd64", 3000, 12, 12, 128, 2),
    ("unaligned", 2000, 12, 12, 30, 3),
    ("pool_ragged", 37 * 41, 1, 12, 64, 4),
]


def temporal_inputs(row, dtype, generator):
    """q, k, v as the TemporalTransformer makes them: thirds of one fused
    qkv projection for a layer (Tq = S); for the pooling (Tq = 1) one query
    vector broadcast over the pixels (stride 0) and separate keys and
    values; otherwise separate q, k, v."""
    _, n, tq, s, c, _ = row
    if tq == s:
        qkv = torch.randn(n, s, 3 * c, device="cuda", generator=generator)
        return [t for t in qkv.to(dtype).chunk(3, -1)]
    query = torch.randn(
        1 if tq == 1 else n, tq, c, device="cuda", generator=generator
    )
    k, v = (
        torch.randn(n, s, c, device="cuda", generator=generator).to(dtype)
        for _ in range(2)
    )
    return [query.to(dtype).expand(n, tq, c), k, v]


def temporal_bound_ms(row, q: torch.Tensor, backward: bool):
    """Bytes: q, k, v read and out written (backward: q, k, v, g read, dq,
    dk, dv written). q counts as stored: one Tq x C block where it is
    broadcast along N (stride 0, the pooling query), and then dq is the
    Tq x C gradient of that block. Operations per (pixel, head, query
    step): 4 S head_dim (logits, weighted sum), 10 S head_dim in the
    backward."""
    _, n, tq, s, c, _ = row
    q_elems = (1 if q.stride(0) == 0 else n) * tq * c
    out_elems, kv_elems = n * tq * c, n * s * c
    if backward:
        elems = 2 * q_elems + out_elems + 4 * kv_elems
        ops = 10 * n * tq * s * c
    else:
        elems = q_elems + out_elems + 2 * kv_elems
        ops = 4 * n * tq * s * c
    bytes_moved = elems * q.element_size()
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def temporal_plan(q, k, v, heads: int, backward: bool) -> dict:
    """The tile plan a launch on these tensors runs
    (``temporal_cuda._tile_plan``)."""
    import dataclasses

    from cultionet_tpu_torch.ops import temporal_cuda

    plan = temporal_cuda._plan_for(q, k, v, heads, backward)
    return dataclasses.asdict(plan) | {
        "vec": temporal_cuda._vectorized(q.shape[2], q, k, v)
    }


def sdpa_ms(q, k, v, heads: int, g=None):
    """Median time of torch's scaled_dot_product_attention on the same
    inputs as (N, heads, steps, head_dim) views (forward, or forward and
    backward when a cotangent ``g`` is given); the yardstick, used nowhere
    in the port. Where it refuses the whole batch (its fused kernels may
    cap the batch below N), it runs in chunks of 65,535 pixels; returns
    (ms, chunked)."""
    import torch.nn.functional as F

    def heads_view(t):
        return t.unflatten(-1, (heads, -1)).transpose(1, 2)

    def run(chunk):
        for start in range(0, q.shape[0], chunk):
            part = [t[start:start + chunk] for t in (q, k, v)]
            if g is None:
                F.scaled_dot_product_attention(*map(heads_view, part))
                continue
            leaves = [t.detach().requires_grad_() for t in part]
            out = F.scaled_dot_product_attention(*map(heads_view, leaves))
            torch.autograd.grad(
                out, leaves, heads_view(g[start:start + chunk])
            )

    try:
        run(q.shape[0])
        torch.cuda.synchronize()
        return device_ms(lambda: run(q.shape[0]), 5, 3), False
    except RuntimeError:
        return device_ms(lambda: run(65535), 5, 3), True


def _temporal_record(kernel, row, dtype, err, tol, **extra):
    label, n, tq, s, c, heads = row
    return {
        "phase": "kernel_check",
        "kernel": kernel,
        "call": label,
        "shape": {"N": n, "Tq": tq, "S": s, "C": c, "heads": heads},
        "dtype": str(dtype).replace("torch.", ""),
        "max_abs_err": err,
        "tol": tol,
        **extra,
    }


def phase_temporal_fwd() -> dict:
    from cultionet_tpu_torch.ops.temporal import temporal_attention_reference
    from cultionet_tpu_torch.ops.temporal_cuda import launch_temporal_fwd

    gen = torch.Generator(device="cuda").manual_seed(6)
    records = []
    for row in TEMPORAL_ROWS + TEMPORAL_EXTRA:
        heads = row[5]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = temporal_inputs(row, dtype, gen)
            out = launch_temporal_fwd(q, k, v, heads)
            ref = temporal_attention_reference(
                q.float(), k.float(), v.float(), heads
            )
            err = (out.float() - ref).abs().max().item()
            tol = 1e-5 if dtype == torch.float32 else 2e-2
            record = _temporal_record(
                "temporal_fwd", row, dtype, err, tol,
                plan=temporal_plan(q, k, v, heads, False),
            )
            require(bool(torch.isfinite(out).all()), f"non-finite {record}")
            require(err <= tol, f"kernel disagrees with plain: {record}")
            if row in TEMPORAL_ROWS:
                bound, by = temporal_bound_ms(row, q, False)
                record["ms"] = device_ms(
                    lambda: launch_temporal_fwd(q, k, v, heads)
                )
                record["plain_ms"] = median_ms(
                    lambda: temporal_attention_reference(q, k, v, heads),
                    iters=10,
                )
                record["library_ms"], record["library_chunked"] = sdpa_ms(
                    q, k, v, heads
                )
                record["bound_ms"] = bound
                record["bound_by"] = by
            emit(record)
            records.append(record)
            del q, k, v, out, ref
    torch.cuda.empty_cache()
    return summarize_rows(records, "predict_")


def phase_temporal_bwd() -> dict:
    from cultionet_tpu_torch.ops.temporal import temporal_attention_reference
    from cultionet_tpu_torch.ops.temporal_cuda import launch_temporal_bwd

    gen = torch.Generator(device="cuda").manual_seed(7)
    records = []
    for row in TEMPORAL_ROWS + TEMPORAL_EXTRA:
        heads = row[5]
        for dtype in (torch.float32, torch.bfloat16):
            if row[0] == "long_query" and dtype == torch.bfloat16:
                continue
            q, k, v = temporal_inputs(row, dtype, gen)
            g = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
            got = launch_temporal_bwd(q, k, v, g, heads)
            again = launch_temporal_bwd(q, k, v, g, heads)
            leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
            ref = torch.autograd.grad(
                temporal_attention_reference(*leaves, heads), leaves, g.float()
            )
            errs = [(a.float() - r).abs().max().item() for a, r in zip(got, ref)]
            tol = 1e-4 if dtype == torch.float32 else 5e-2
            record = _temporal_record(
                "temporal_bwd", row, dtype, max(errs), tol,
                max_abs_err_dq_dk_dv=errs,
                plan=temporal_plan(q, k, v, heads, True),
            )
            require(
                all(bool(torch.isfinite(t).all()) for t in got),
                f"non-finite {record}",
            )
            require(max(errs) <= tol, f"kernel disagrees: {record}")
            require(
                all(torch.equal(a, b) for a, b in zip(got, again)),
                f"two launches differ: {record}",
            )
            if row in TEMPORAL_ROWS:
                bound, by = temporal_bound_ms(row, q, True)

                def plain_fwd_bwd():
                    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                    out = temporal_attention_reference(*leaves, heads)
                    return torch.autograd.grad(out, leaves, g)

                record["ms"] = device_ms(
                    lambda: launch_temporal_bwd(q, k, v, g, heads)
                )
                record["plain_ms"] = median_ms(plain_fwd_bwd, iters=10)
                record["library_ms"], record["library_chunked"] = sdpa_ms(
                    q, k, v, heads, g
                )
                record["bound_ms"] = bound
                record["bound_by"] = by
            emit(record)
            records.append(record)
            del q, k, v, g, got, again, ref, leaves
    torch.cuda.empty_cache()
    return summarize_rows(records, "train_")


NA_BLOCK_SITES = [  # (B, H, W, C, heads, kernel, dilation): up_cu, up_bu, up_au
    (8, 35, 35, 256, 8, 3, 1),
    (8, 70, 70, 256, 4, 3, 1),
    (8, 140, 140, 256, 4, 3, 2),
]
NA_BLOCK_EXTRA = [  # ragged, k = 1, C = 64 with 4 heads, B = 1, padded C
    (2, 37, 35, 256, 8, 3, 1),
    (2, 35, 35, 256, 8, 1, 1),
    (2, 35, 35, 64, 4, 3, 1),
    (1, 140, 140, 256, 4, 3, 2),
    (2, 22, 20, 40, 5, 3, 2),
]
NA_BLOCK_TRAIN_SITES = [  # the same sites on 100-px training chips, B=4
    (4, 25, 25, 256, 8, 3, 1),
    (4, 50, 50, 256, 4, 3, 1),
    (4, 100, 100, 256, 4, 3, 2),
]
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak (700 W)


LAYER_NORM_ROWS = [  # (call, shape, calls a predict forward): the transformer's
    ("tokens", (156_800, 12, 64), 5),  # the four pre-LN blocks, the pooling keys
    ("embedding", (156_800, 64), 1),
    ("pool_query", (1, 1, 64), 1),
]
LAYER_NORM_EXTRA = [  # a ragged row count, narrow and wide rows
    ("ragged", (100_003, 64), 0),
    ("width_24", (9_999, 24), 0),
    ("width_256", (40_000, 256), 0),
    ("width_1024", (3_001, 1024), 0),
    ("width_36", (50_001, 36), 0),
    ("width_4", (20_000, 4), 0),
    ("width_5", (20_000, 5), 0),
]


def layer_norm_tolerance(want, dtype) -> float:
    """fp32: 1e-5; bf16: one bf16 ulp at the output's largest magnitude
    (the kernel and PyTorch sum in another order, and each rounds once)."""
    import math

    if dtype == torch.float32:
        return 1e-5
    scale = want.float().abs().max().item()
    return 2.0 ** (math.floor(math.log2(scale)) - 7) if scale > 0 else 0.0


def phase_layer_norm() -> dict:
    """The LayerNorm kernel against ``F.layer_norm`` (its plain version
    and the yardstick) at the transformer's predict calls and the extras;
    device times at the predict calls."""
    import torch.nn.functional as F

    from cultionet_tpu_torch.ops import layer_norm_cuda

    gen = torch.Generator(device="cuda").manual_seed(11)
    records = []
    for call, shape, calls in LAYER_NORM_ROWS + LAYER_NORM_EXTRA:
        width = shape[-1]
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(shape, device="cuda", generator=gen) * 2 + 0.5).to(dtype)
            w = (1 + 0.2 * torch.randn(width, device="cuda", generator=gen)).to(dtype)
            b = (0.2 * torch.randn(width, device="cuda", generator=gen)).to(dtype)
            out = layer_norm_cuda.launch_layer_norm_rows(x, w, b, 1e-5)
            want = F.layer_norm(x, (width,), w, b, 1e-5)
            err = (out.float() - want.float()).abs().max().item()
            tol = layer_norm_tolerance(want, dtype)
            rows = x.numel() // width
            record = {
                "phase": "kernel_check",
                "kernel": "layer_norm_rows",
                "call": call,
                "shape": list(shape),
                "dtype": str(dtype).replace("torch.", ""),
                "max_abs_err": err,
                "tol": tol,
                "plan": layer_norm_cuda.card_plan(dtype, rows, width, x.device),
            }
            require(bool(torch.isfinite(out).all()), f"non-finite {record}")
            require(err <= tol, f"kernel disagrees with F.layer_norm: {record}")
            if calls:
                record["calls_a_forward"] = calls
                record["ms"] = device_ms(
                    lambda: layer_norm_cuda.launch_layer_norm_rows(x, w, b, 1e-5)
                )
                record["library_ms"] = device_ms(
                    lambda: F.layer_norm(x, (width,), w, b, 1e-5)
                )
                record["plain_ms"] = record["library_ms"]
                record["bound_ms"] = (
                    2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
                )
                record["bound_by"] = "bytes"
                record["share_of_bound"] = record["bound_ms"] / record["ms"]
            emit(record)
            records.append(record)
            del x, w, b, out, want
    torch.cuda.empty_cache()
    timed = [r for r in records if "ms" in r and r["dtype"] == "bfloat16"]
    summary = {
        "max_abs_err": max(r["max_abs_err"] for r in records if r["dtype"] == "bfloat16"),
        "bound_by": "bytes",
    }
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        summary[key] = sum(r[key] * r["calls_a_forward"] for r in timed)
    emit({"phase": "layer_norm_forward", "dtype": "bfloat16", **summary})
    return summary


def na_block_params_on_card(channels: int, generator):
    """The block's eight fp32 parameters with model-like scales: weights
    N(0, 1/C) (lecun-normal), LayerNorm scales N(1, 0.1), biases
    N(0, 0.1)."""
    from cultionet_tpu_torch.ops.na_block import PARAM_KEYS

    shapes = {
        "w_qkv": (channels, 3 * channels),
        "b_qkv": (3 * channels,),
        "w_proj": (channels, channels),
    }
    params = {}
    for key in PARAM_KEYS:
        value = torch.randn(
            shapes.get(key, (channels,)), device="cuda", generator=generator
        )
        if key.startswith("w_"):
            value = value * channels**-0.5
        elif key.endswith("scale"):
            value = 1.0 + 0.1 * value
        else:
            value = 0.1 * value
        params[key] = value
    return params


def na_block_bound_ms(site, itemsize: int):
    """max(bytes / 3.35 TB/s, 2 N C 4C / 989 TFLOP/s + 4 N C k^2 / 67
    TFLOP/s): x read once, out written once and the bf16 weights read once;
    the two products at the bf16 tensor-core rate and the attention's
    logits and weighted sum at the fp32 rate."""
    b, h, w, c, _, k, _ = site
    n = b * h * w
    bytes_moved = 2 * n * c * itemsize + 4 * c * c * 2
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = (
        2 * n * c * 4 * c / BF16_OPS_PER_S + 4 * n * c * k * k / FP32_OPS_PER_S
    ) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def na_block_composition(x, params, heads: int, kernel_size: int, dilation: int):
    """The port's unfused composition of the same block, the yardstick:
    LayerNorm, linear, the NA kernel #1, linear, LayerNorm, in x's dtype
    (``params`` already cast, the weights as (out, in))."""
    import torch.nn.functional as F

    from cultionet_tpu_torch.ops.natten_cuda import na2d_cuda

    c = x.shape[-1]
    h = F.layer_norm(x, (c,), params["ln1_scale"], params["ln1_bias"], 1e-6)
    qkv = F.linear(h, params["w_qkv"], params["b_qkv"])
    q, k, v = (t.unflatten(-1, (heads, -1)) for t in qkv.chunk(3, -1))
    out = na2d_cuda(q, k, v, kernel_size, dilation).flatten(-2)
    out = F.linear(out, params["w_proj"], params["b_proj"])
    return F.layer_norm(out, (c,), params["ln2_scale"], params["ln2_bias"], 1e-6)


def na_block_profile() -> dict:
    """Device time of kernel #7 at the largest decoder site in bf16 (one
    launch on prepared weights, profiled): the profile must show one
    kernel, ``na_block_kernel``."""
    from torch.profiler import ProfilerActivity, profile

    from cultionet_tpu_torch.ops.na_block_cuda import (
        launch_prepared,
        prepare_weights,
    )

    b, h, w, c, heads, k, d = NA_BLOCK_SITES[-1]
    gen = torch.Generator(device="cuda").manual_seed(13)
    weights = prepare_weights(na_block_params_on_card(c, gen), heads)
    x = torch.randn(b, h, w, c, device="cuda", generator=gen).bfloat16()
    launch_prepared(x, weights, heads, k, d)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        launch_prepared(x, weights, heads, k, d)
        torch.cuda.synchronize()
    events, total_us, top = device_time_by_kernel(prof, 6)
    names = [e.key for e in events]
    require(
        len(names) == 1 and "na_block_kernel" in names[0],
        f"na_block_fwd_profile: one kernel expected, got {names}",
    )
    return {"shape": [b, h, w, c], "dtype": "bfloat16",
            "device_ms": total_us / 1e3, "top": top}


def phase_na_block_fwd() -> dict:
    """Kernel #7 against ``na_block_plain`` at the decoder's NA sites and
    the extras; every record is printed before the limits are applied.

    ``ms`` times the launch on weights that ``prepare_weights`` laid out
    once (as ``library_ms`` times the composition on weights cast once);
    ``prep_ms`` times that preparation, which ``launch_na_block_fwd`` runs
    on every call. The public wrapper must give the launch's bits.

    Limits. bf16 x: <= 2e-2 against the plain version in fp32 on the same
    bf16 inputs. fp32 x: <= 2e-2, and at most 10% of the outputs above
    1e-4. The block's function rounds LN1's output, the attention output
    and each q.k product to bf16; after fp32 sums in another order (tensor
    cores against the plain matmul) a value near a rounding midpoint lands
    on the neighbouring bf16 number, a step of 2^-8 of it, which reaches
    every output of its pixel through the projection and LN2. So no
    implementation that sums in another order holds 1e-4 everywhere; the
    pixels with no such step agree to about 1e-6. The plain version on the
    card against itself on the CPU (``plain_card_vs_cpu``, the extras)
    shows the same spread.
"""
    import dataclasses

    from cultionet_tpu_torch.ops import build
    from cultionet_tpu_torch.ops.na_block import na_block_plain
    from cultionet_tpu_torch.ops.na_block_cuda import (
        _tile_plan,
        launch_na_block_fwd,
        launch_prepared,
        prepare_weights,
    )

    gen = torch.Generator(device="cuda").manual_seed(11)
    records, failures = [], []
    for site in NA_BLOCK_SITES + NA_BLOCK_EXTRA:
        b, h, w, c, heads, k, d = site
        main = site in NA_BLOCK_SITES
        params = na_block_params_on_card(c, gen)
        weights = prepare_weights(params, heads)
        x32 = torch.randn(b, h, w, c, device="cuda", generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            out = launch_prepared(x, weights, heads, k, d)
            ref = na_block_plain(x.float(), params, heads, k, d)
            torch.cuda.synchronize()
            diff = (out.float() - ref).abs()
            err = diff.max().item()
            share = (diff > 1e-4).float().mean().item()
            tol = 2e-2
            record = {
                "phase": "kernel_check",
                "kernel": "na_block_fwd",
                "shape": [b, h, w, c],
                "heads": heads,
                "kernel_size": k,
                "dilation": d,
                "dtype": str(dtype).replace("torch.", ""),
                "max_abs_err": err,
                "share_above_1e-4": share,
                "tol": tol,
            }
            ok = bool(torch.isfinite(out).all()) and err <= tol
            if dtype == torch.float32:
                record["share_limit"] = 0.1
                ok = ok and share <= 0.1
            record["wrapper_equal"] = bool(
                torch.equal(launch_na_block_fwd(x, params, heads, k, d), out)
            )
            ok = ok and record["wrapper_equal"]
            if not main and dtype == torch.float32:
                cpu = na_block_plain(
                    x.cpu(), {key: v.cpu() for key, v in params.items()},
                    heads, k, d,
                )
                spread = (cpu - ref.cpu()).abs()
                record["plain_card_vs_cpu"] = {
                    "max_abs": spread.max().item(),
                    "share_above_1e-4": (spread > 1e-4).float().mean().item(),
                }
            if not ok:
                failures.append(record)
            if main:
                bound, by = na_block_bound_ms(site, x.element_size())
                record["ms"] = device_ms(
                    lambda: launch_prepared(x, weights, heads, k, d)
                )
                record["prep_ms"] = device_ms(
                    lambda: prepare_weights(params, heads), 10, 3
                )
                record["plain_ms"] = median_ms(
                    lambda: na_block_plain(x, params, heads, k, d), iters=10
                )
                cast = {
                    key: (v.t().contiguous() if key.startswith("w_") else v).to(dtype)
                    for key, v in params.items()
                }
                record["library_ms"] = device_ms(
                    lambda: na_block_composition(x, cast, heads, k, d), 10, 3
                )
                record["library"] = "composition"
                record["bound_ms"] = bound
                record["bound_by"] = by
                record["share_of_bound"] = bound / record["ms"]
            record["plan"] = dataclasses.asdict(
                _tile_plan(h, w, k, d, c, heads, x.element_size(), b)
            )
            emit(record)
            records.append(record)
            del x, out, ref, diff
        del weights
        torch.cuda.empty_cache()
    require(not failures, f"na_block_fwd disagrees with plain: {failures}")
    _, log = build.compile_library("na_block_fwd")
    emit(
        {"phase": "na_block_fwd_profile", **na_block_profile(),
         "ptxas": ptxas_report(log)}
    )
    summary = summarize(records, "bfloat16")
    summary["library_ms"] = sum(
        r["library_ms"] for r in records
        if r["dtype"] == "bfloat16" and "library_ms" in r
    )
    return summary


def phase_na_block_grad() -> dict:
    """``fused_na_block`` forward and backward at the train sites in fp32:
    the gradients of x and of every parameter against autograd of
    ``na_block_reference`` on the card (the same backward), within 1e-5 of
    the largest entry; one ``na_block_fwd`` launch per forward."""
    from cultionet_tpu_torch.ops.na_block import (
        PARAM_KEYS,
        fused_na_block,
        na_block_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(12)
    total = {}
    rows = []
    for site in NA_BLOCK_TRAIN_SITES:
        b, h, w, c, heads, k, d = site
        params = na_block_params_on_card(c, gen)
        x = torch.randn(b, h, w, c, device="cuda", generator=gen)
        g = torch.randn(b, h, w, c, device="cuda", generator=gen)

        def grads(fn):
            xs = x.clone().requires_grad_()
            ps = {key: v.clone().requires_grad_() for key, v in params.items()}
            fn(xs, ps, heads, k, d).backward(g)
            return {"x": xs.grad, **{key: ps[key].grad for key in PARAM_KEYS}}

        zero_launches()
        got = grads(fused_na_block)
        launches = read_launches()
        want = grads(na_block_reference)
        top = max(t.abs().max().item() for t in want.values())
        rel = max((got[n] - want[n]).abs().max().item() for n in want) / top
        require(
            launches["na_block_fwd"] == 1,
            f"na_block_grad {site}: launches {launches}",
        )
        require(rel <= 1e-5, f"na_block_grad {site}: {rel} of the largest")
        for name, count in launches.items():
            total[name] = total.get(name, 0) + count
        rows.append(
            {"shape": [b, h, w, c], "heads": heads, "dilation": d,
             "grad_rel_to_largest": rel,
             "launches": {n: v for n, v in launches.items() if v}}
        )
        del x, g, got, want
    torch.cuda.empty_cache()
    emit(
        {"phase": "na_block_grad", "dtype": "float32", "sites": rows,
         "limit": 1e-5, "launches": total}
    )
    return total


def summarize_rows(records, prefix: str) -> dict:
    """As ``summarize`` over the bf16 timed records whose call starts with
    ``prefix`` (one layer call and one pooling call), with the library
    call's time."""
    chosen = [r for r in records if r["call"].startswith(prefix)]
    summary = summarize(chosen, "bfloat16")
    summary["library_ms"] = sum(
        r["library_ms"] for r in chosen if r["dtype"] == "bfloat16"
    )
    return summary


def train_setup(dropout: float, temporal_encoder: str = "conv"):
    """The CLI-default model at full width (weights not yet drawn) and its
    CLI-default optimizer: AdamW, OneCycle peak 0.01 over 100 epochs of
    TRAIN_STEPS steps with the beta1 cycle, weight decay 1e-3, global-norm
    clip 1.0."""
    from cultionet_tpu_torch.train.optim import (
        build_momentum_schedule,
        build_optimizer,
        build_schedule,
    )

    model = cli_model(temporal_encoder, dropout)
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


def step_launches(temporal_encoder: str, dropout: bool) -> dict:
    """Kernel launches of one train step: the decoder's three NA calls
    (the dropout kernels when the step has dropout) forward and backward,
    and for the transformer its two layers' and its pooling's temporal
    attention forward and backward."""
    want = {name: 0 for name in read_launches()}
    suffix = "_drop" if dropout else ""
    want[f"na2d_fwd{suffix}"] = want[f"na2d_bwd{suffix}"] = 3
    if temporal_encoder == "transformer":
        want["temporal_fwd"] = want["temporal_bwd"] = 3
    return want


def phase_train(smi: str, temporal_encoder: str = "conv"):
    from cultionet_tpu_torch.train.step import (
        create_train_state,
        make_train_step,
    )

    phase = "train" if temporal_encoder == "conv" else "train_transformer"
    model, tx = train_setup(dropout=0.2, temporal_encoder=temporal_encoder)
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
    require(all(np.isfinite(losses)), f"{phase} losses {losses}")
    require(losses[-1] < losses[0], f"{phase} loss did not fall: {losses}")
    want = {
        k: timed * n for k, n in step_launches(temporal_encoder, True).items()
    }
    require(launches == want, f"{phase} launches {launches}, want {want}")
    emit(
        {
            "phase": phase,
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


def grad_diffs(got: dict, want: dict) -> T.Tuple[float, float, list]:
    """(largest max|got - want| over tensors relative to the largest entry
    of all of ``want``; largest over tensors of max|got - want| relative to
    that tensor's own largest entry; the tensors the second skips). The
    second skips tensors whose own largest entry is below 1e-5 of the
    largest overall: gradients that are zero up to round-off, such as the
    pooling keys' bias in the transformer, which the softmax's invariance
    to a shift of all logits makes zero, have no scale of their own; the
    first still bounds them."""
    top = max(ref.abs().max().item() for ref in want.values())
    worst_global = worst_own = 0.0
    skipped = []
    for name, ref in want.items():
        diff = (got[name].cpu() - ref.cpu()).abs().max().item()
        worst_global = max(worst_global, diff / top)
        scale = ref.abs().max().item()
        if scale > 1e-5 * top:
            worst_own = max(worst_own, diff / scale)
        else:
            skipped.append(name)
    return worst_global, worst_own, skipped


def require_grads_close(label: str, got: dict, want: dict) -> dict:
    """Gradient limits: 1e-4 of the largest entry overall, 1e-2 of each
    tensor's own largest entry (a bias gradient sums a whole map of nearly
    cancelling terms, so its own scale can sit far below the rounding of
    its terms)."""
    rel_global, rel_own, skipped = grad_diffs(got, want)
    require(rel_global <= 1e-4, f"{label}: grads {rel_global} of the largest")
    require(rel_own <= 1e-2, f"{label}: grads {rel_own} of their own largest")
    return {
        "grad_rel_to_largest": rel_global,
        "grad_rel_to_own_largest": rel_own,
        "zero_to_round_off": skipped,
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


def phase_train_parity(temporal_encoder: str = "conv") -> dict:
    import copy

    from cultionet_tpu_torch.data.synthetic import create_batch
    from cultionet_tpu_torch.nn.init import init_parameters_
    from cultionet_tpu_torch.train.step import (
        create_train_state,
        make_train_step,
    )

    phase = "train_parity"
    if temporal_encoder != "conv":
        phase = "train_parity_transformer"
    switch = plain_switch(temporal_encoder)
    model, tx = train_setup(dropout=0.0, temporal_encoder=temporal_encoder)
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
    want = step_launches(temporal_encoder, False)
    require(launches == want, f"{phase} launches {launches}, want {want}")
    require(np.isfinite(float(logs["loss"])), f"{phase} step loss")
    del state

    kernel_loss, kernel_grads = loss_and_grads(
        copy.deepcopy(model), batch, "cuda"
    )
    switch(False)
    try:
        plain_loss, plain_grads = loss_and_grads(
            copy.deepcopy(model), batch, "cuda"
        )
    finally:
        switch(True)
    loss_err = abs(kernel_loss - plain_loss)
    require(loss_err <= 1e-5, f"{phase}: kernel vs plain loss {loss_err}")
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
    require(
        cpu_loss_err <= 1e-5, f"{phase}: card vs CPU loss {cpu_loss_err}"
    )
    cpu_diffs = require_grads_close("card vs CPU", card_grads, cpu_grads)
    emit(
        {
            "phase": phase,
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


def phase_train_profile(
    state, batch, steps_per_s: float, temporal_encoder: str = "conv"
) -> None:
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
    # The NA kernels by name (csrc/na2d_fwd.cu, na2d_bwd.cu); each must show,
    # so a renamed kernel cannot report 0 ms.
    na = {
        name: sum(
            e.device_time_total for e in events if f"{name}_kernel" in e.key
        )
        / 1e3
        for name in ("na2d_fwd", "na2d_bwd_query", "na2d_bwd_key")
    }
    require(
        all(ms > 0 for ms in na.values()),
        f"train_profile: an NA kernel shows no device time {na}",
    )
    temporal = {
        name: sum(
            e.device_time_total for e in events if f"{name}_kernel" in e.key
        )
        / 1e3
        for name in ("temporal_fwd", "temporal_bwd")
    }
    phase = "train_profile"
    if temporal_encoder != "conv":
        phase = "train_profile_transformer"
    emit(
        {
            "phase": phase,
            "batch": [4, 12, 100, 100, 3],
            "precision": "16-mixed",
            "device_ms": total_us / 1e3,
            # Against the host-timed step of phase train, same run.
            "device_idle_share": 1.0 - total_us / 1e6 * steps_per_s,
            "na_kernels_ms": na,
            "na_share": sum(na.values()) * 1e3 / total_us
            if total_us
            else None,
            "temporal_kernels_ms": temporal,
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


FIT_CHIPS = 20  # 100 x 100, T = 12, 3 bands: 16 train and 4 validation chips


def write_fit_chips(root) -> None:
    """FIT_CHIPS seeded chips with labels and boundary distances, x and
    bdist packed to int16 x 10000 as the chip creator writes them."""
    from cultionet_tpu_torch.data.synthetic import create_batch

    rng = np.random.default_rng(21)
    for _ in range(FIT_CHIPS):
        batch = create_batch(
            num_channels=3, num_time=12, height=100, width=100, rng=rng
        )
        batch = batch.replace(
            x=(batch.x * 10000).to(torch.int16),
            bdist=(batch.bdist * 10000).to(torch.int16),
        )
        batch.to_file(root / "processed" / batch.batch_id[0])


def fit_params(
    root, ckpt, norm, epochs: int, augment_prob: float = 0.0, **options
):
    """The CLI's training defaults (hidden 64, natten, dropout 0.2,
    dilations [1, 2], "16-mixed", AdamW + OneCycle peak 0.01, weight decay
    1e-3, clip 1.0, batch 4, val_frac 0.2), host augmentation at
    ``augment_prob`` (the CLI's default is 0.5); ``options`` set other
    fields."""
    from cultionet_tpu_torch.config import CultionetParams
    from cultionet_tpu_torch.data.datasets import ChipDataset

    return CultionetParams(
        ckpt_file=ckpt / "last.ckpt",
        dataset=ChipDataset(root, norm_values=norm),
        val_frac=0.2,
        batch_size=4,
        hidden_channels=64,
        attention_weights="natten",
        dropout=0.2,
        dilations=[1, 2],
        activation_type="SiLU",
        precision="16-mixed",
        learning_rate=0.01,
        weight_decay=1e-3,
        gradient_clip_val=1.0,
        augment_prob=augment_prob,
        epochs=epochs,
        **{"optimizer": "AdamW", "lr_scheduler": "OneCycleLR", **options},
    )


def fit_launches(train_steps: int, val_batches: int) -> dict:
    """Per train step 3 launches of each NA dropout kernel; per validation
    batch 3 of the NA forward; nothing else."""
    want = {name: 0 for name in read_launches()}
    want["na2d_fwd_drop"] = want["na2d_bwd_drop"] = 3 * train_steps
    want["na2d_fwd"] = 3 * val_batches
    return want


def require_states_equal(got, want) -> None:
    """Parameters, buffers, step and optimizer state equal bit for bit."""
    for name, value in want.model.state_dict().items():
        require(
            torch.equal(got.model.state_dict()[name], value),
            f"fit: restored {name} differs",
        )
    require(got.step == want.step, f"fit: step {got.step} != {want.step}")
    g, w = got.optimizer.state_dict(), want.optimizer.state_dict()
    require(g["count"] == w["count"], "fit: optimizer count differs")
    for key, entry in w["torch_optimizer"]["state"].items():
        for name, value in entry.items():
            require(
                torch.equal(
                    g["torch_optimizer"]["state"][key][name].cpu(), value.cpu()
                ),
                f"fit: optimizer state {key}.{name} differs",
            )


def loader_s(
    root, norm, augment_prob: float, epochs: int = 1, batches: int = 4
) -> float:
    """Host seconds for the loader alone to deliver ``epochs`` epochs of
    the train split to the card (``batches`` batches of 4 each), at
    ``augment_prob``: the loading, augmentation draws and batch order of
    the first ``epochs`` epochs of ``fit`` on the same chips."""
    from cultionet_tpu_torch.data.datasets import ChipDataset
    from cultionet_tpu_torch.data.loader import ChipLoader

    train_ds, _ = ChipDataset(root, norm_values=norm).split_train_val(0.2)
    train_ds.augment_prob = augment_prob
    loader = ChipLoader(
        train_ds, batch_size=4, shuffle=True, drop_last=True, device="cuda"
    )
    start = time.perf_counter()
    loaded = sum(len(list(loader)) for _ in range(epochs))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    require(loaded == batches * epochs, f"loader gave {loaded} batches")
    return seconds


def phase_fit(train_steps_per_s: float, workdir) -> dict:
    """The fit loop from chip files: normalization statistics, 2 epochs
    with checkpoints, a resume to 3 epochs, then the best checkpoint
    through ScenePredictor. The chips and checkpoints stay in ``workdir``
    for the phases after it."""
    import copy

    from torch.profiler import ProfilerActivity, profile

    from cultionet_tpu_torch.data.datasets import ChipDataset
    from cultionet_tpu_torch.model import fit, load_model
    from cultionet_tpu_torch.predict import ScenePredictor
    from cultionet_tpu_torch.train.checkpoint import Checkpointer
    from cultionet_tpu_torch.utils.normalize import NormValues

    root, ckpt = workdir / "chips", workdir / "ckpt"
    start = time.perf_counter()
    write_fit_chips(root)
    norm = NormValues.from_dataset(
        ChipDataset(root), {"max_crop_class": 1, "edge_class": 2}
    )
    setup_s = time.perf_counter() - start

    zero_launches()
    start = time.perf_counter()
    first = fit(fit_params(root, ckpt, norm, epochs=2))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - start
    launches = read_launches()
    steps_per_epoch, val_batches = 4, 1
    require(
        launches == fit_launches(2 * steps_per_epoch, 2 * val_batches),
        f"fit (2 epochs) launched {launches}",
    )
    store = ckpt / "last_store"
    for which in ("last", "best"):
        require((store / which / "model.pt").exists(), f"fit: no {which}")
    require(len(first.history) == 2, f"fit: history {first.history}")
    require(first.state.step == 8, f"fit: step {first.state.step}")
    template = copy.deepcopy(first.state.model)
    with torch.no_grad():
        for p in template.parameters():
            p.zero_()
    restored = Checkpointer(store).restore(
        type(first.state)(
            model=template,
            optimizer=first.state.optimizer.spec.init(template.parameters()),
        ),
        "last",
    )
    require_states_equal(restored, first.state)
    del first, restored, template

    zero_launches()
    start = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        resumed = fit(fit_params(root, ckpt, norm, epochs=3))
        torch.cuda.synchronize()
    resumed_s = time.perf_counter() - start
    resumed_launches = read_launches()
    _, device_us, top = device_time_by_kernel(prof, 8)
    require(
        resumed_launches == fit_launches(steps_per_epoch, val_batches),
        f"fit (resumed) launched {resumed_launches}",
    )
    require(
        [r["epoch"] for r in resumed.history] == [2],
        f"fit: resumed history {resumed.history}",
    )
    require(resumed.state.step == 12, f"fit: step {resumed.state.step}")
    # Where an epoch's host time goes: the loader alone over the train
    # split, and one checkpoint save.
    loader_epoch_s = loader_s(root, norm, augment_prob=0.0)
    start = time.perf_counter()
    Checkpointer(workdir / "timing").save_last(resumed.state, 0)
    save_s = time.perf_counter() - start
    rows = (ckpt / "history.csv").read_text().splitlines()
    require(len(rows) == 1 + 3, f"fit: history.csv has {len(rows)} lines")
    history = [
        {k: float(v) for k, v in zip(rows[0].split(","), r.split(","))}
        for r in rows[1:]
    ]
    for row in history:
        for key in ("loss", "val_loss", "val_score"):
            require(np.isfinite(row[key]), f"fit: {key} {row}")
    del resumed

    _, model = load_model(store, "best")
    scene = (
        np.random.default_rng(0).random((12, 420, 420, 3)) * 10000.0
    ).astype("int16")
    predictor = ScenePredictor(model, batch_size=8, device="cuda")
    zero_launches()
    raster, _ = predictor.predict_scene(scene, window_size=100, padding=20)
    predict_launches = read_launches()
    want = {name: 0 for name in predict_launches}
    want["na2d_fwd"] = 12
    require(predict_launches == want, f"fit predict {predict_launches}")
    require(
        raster.shape == (420, 420, 3) and bool(np.isfinite(raster).all()),
        "fit: predicted raster not finite",
    )
    del model, predictor

    epoch_s = first_s - resumed_s  # one epoch; set-up cancels
    result = {
        "launches": launches,
        "root": root,
        "norm": norm,
        "store": store,
        "epoch_train_chips_per_s": 4 * steps_per_epoch / epoch_s,
        "fit_2_epochs_s": first_s,
    }
    emit(
        {
            "phase": "fit",
            "chips": [FIT_CHIPS, 12, 100, 100, 3],
            "train_chips_per_epoch": 4 * steps_per_epoch,
            "val_chips_per_epoch": 4 * val_batches,
            "precision": "16-mixed",
            "setup_s": setup_s,
            "fit_2_epochs_s": first_s,
            "fit_resumed_1_epoch_s": resumed_s,
            "epoch_s": epoch_s,
            "epoch_train_chips_per_s": 4 * steps_per_epoch / epoch_s,
            "loader_epoch_s": loader_epoch_s,
            "checkpoint_save_s": save_s,
            "bare_step_chips_per_s": 4 * train_steps_per_s,
            "resumed_run_device_ms": device_us / 1e3,
            "resumed_run_device_idle_share": 1.0 - device_us / 1e6 / resumed_s,
            "resumed_run_top": top,
            "history": history,
            "launches": launches,
            "resumed_launches": resumed_launches,
            "predict_launches": predict_launches,
        }
    )
    return result


EXPORT_BATCH = 8  # the CLI's predict batch of 140-px windows (100 + 2 x 20)
EXPORT_TIMED_CALLS = 10
SERVE_SCRIPT = """
import json, sys, time
import numpy as np, torch
from cultionet_tpu_torch.export import load_predictor
from cultionet_tpu_torch.ops import flags

# fp32 arithmetic in fp32 programs, as in the parent process.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
args = json.loads(sys.argv[1])
x = torch.from_numpy(np.load(args["wire"])).cuda()
lat = torch.zeros(x.shape[0], device="cuda")
lon = torch.zeros(x.shape[0], device="cuda")
counters = flags.launch_tables()
report, rasters = {}, {}
for name, path in args["artifacts"].items():
    start = time.perf_counter()
    pred = load_predictor(path)
    load_s = time.perf_counter() - start
    pred.call_on_device(x, lat, lon)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(args["calls"]):
        pred.call_on_device(x, lat, lon)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    # The compared call: cuDNN's deterministic algorithms (its default
    # transposed convolutions accumulate in a varying order).
    torch.backends.cudnn.deterministic = True
    for counter in counters:
        for key in counter:
            counter[key] = 0
    out = pred.call_on_device(x, lat, lon)
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = False
    launches = {k: v for c in counters for k, v in c.items() if v}
    code = pred.program.graph_module.code
    report[name] = {
        "load_s": load_s,
        "launches_per_call": launches,
        "served_chips_per_s": x.shape[0] * args["calls"] / seconds,
        "graph_ops": pred.meta["ops"],
        "graph_calls_na2d": code.count("cultionet_tpu_torch.na2d"),
        "graph_calls_temporal": code.count(
            "cultionet_tpu_torch.temporal_attention"),
        "graph_calls_layer_norm": code.count(
            "cultionet_tpu_torch.layer_norm_rows"),
        "kernels": pred.meta["kernels"],
    }
    for band, value in zip(pred.meta["outputs"], out):
        rasters[f"{name}/{band}"] = value.float().cpu().numpy()
np.savez(args["out"], **rasters)
report["model_modules"] = sorted(
    m for m in sys.modules
    if m.startswith(("cultionet_tpu_torch.models", "cultionet_tpu_torch.nn",
                     "jax", "cultionet_tpu."))
)
print(json.dumps(report))
"""


def inprocess_predict(model, precision, x, norm):
    """The in-process predict step (``make_predict_step``) on the int16
    batch ``x`` after the dataset pipeline on the card (1/10000, clip to
    [1e-9, 1], z-score in fp32): its outputs with cuDNN's deterministic
    algorithms (the served program's compared call runs so too), its
    chips/s over EXPORT_TIMED_CALLS calls on the device-resident
    normalized batch with cuDNN's defaults, and the max-abs difference of
    two calls with the defaults."""
    from cultionet_tpu_torch.data.batch import dequantize
    from cultionet_tpu_torch.train.step import make_predict_step

    bands = ("distance", "edge", "crop")
    mean = torch.as_tensor(norm.dataset_mean, device="cuda")
    std = torch.as_tensor(norm.dataset_std, device="cuda")
    vals = (dequantize(x).clamp(1e-9, 1.0) - mean) / std
    step = make_predict_step(model, precision, "cuda")
    first, second = step(vals), step(vals)
    repeat = max(
        float((first[b] - second[b]).abs().max()) for b in bands
    )
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(EXPORT_TIMED_CALLS):
        step(vals)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    torch.backends.cudnn.deterministic = True
    try:
        outputs = step(vals)
    finally:
        torch.backends.cudnn.deterministic = False
    return outputs, x.shape[0] * EXPORT_TIMED_CALLS / seconds, repeat


def phase_export(fit_result: dict, workdir) -> None:
    """The serving export on the card: ``export_predictor`` of the fit
    phase's best checkpoint (the CLI-default conv model) and
    ``export_state`` of the seeded full-width transformer model, each at
    batch 8 of 140-px windows, in bf16 and in fp32, with the fit's norm
    statistics. A fresh process loads the four artifacts with
    ``load_predictor`` alone and must not import the port's model code
    (``cultionet_tpu_torch.models``, ``.nn``); per call it must launch 3
    na2d_fwd (conv) or 3 na2d_fwd, 3 temporal_fwd and 7 layer_norm_rows
    (transformer) and nothing else, and its graph must name the registered
    ops as many times. Its rasters
    on a seeded int16 batch must be within 1e-5 (fp32) and 2e-2 (bf16) of
    the in-process predict step's on the same batch, both computed with
    cuDNN's deterministic algorithms: with its defaults two calls of the
    same fp32 step differ by up to about 1e-5 (recorded). Served chips/s of
    ``call_on_device`` on device-resident inputs beside the in-process
    step's (cuDNN's defaults), the export's seconds and the artifact's
    size."""
    from cultionet_tpu_torch.export import export_predictor, export_state
    from cultionet_tpu_torch.model import load_model

    norm, store = fit_result["norm"], fit_result["store"]
    norm_file = workdir / "export" / "last.norm.npz"
    norm.to_file(norm_file)
    wire = np.random.default_rng(41).integers(
        0, 10000, size=(EXPORT_BATCH, 12, 140, 140, 3), dtype=np.int16
    )
    np.save(workdir / "export" / "wire.npy", wire)
    x = torch.from_numpy(wire).cuda()

    models = {"conv": load_model(store, "best")[1],
              "transformer": build_model("transformer")}
    artifacts, exports = {}, {}
    for front, model in models.items():
        for precision in ("bf16", "fp32"):
            name = f"{front}_{precision}"
            out = workdir / "export" / f"{name}.cnx"
            start = time.perf_counter()
            if front == "conv":
                export_predictor(
                    store, out, batch_size=EXPORT_BATCH, chip_size=140,
                    precision=precision, which="best", norm_file=norm_file,
                )
            else:
                export_state(
                    model, out, in_time=12, in_channels=3,
                    batch_size=EXPORT_BATCH, chip_size=140,
                    precision=precision, norm_mean=norm.dataset_mean,
                    norm_std=norm.dataset_std,
                )
            torch.cuda.synchronize()
            exports[name] = {
                "export_s": time.perf_counter() - start,
                "artifact_bytes": out.stat().st_size,
            }
            artifacts[name] = str(out)

    args = {"artifacts": artifacts, "wire": str(workdir / "export" / "wire.npy"),
            "out": str(workdir / "export" / "served.npz"),
            "calls": EXPORT_TIMED_CALLS}
    start = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", SERVE_SCRIPT, json.dumps(args)],
        capture_output=True, text=True, timeout=600,
        cwd=Path(__file__).resolve().parent,
    )
    subprocess_s = time.perf_counter() - start
    require(
        proc.returncode == 0,
        f"export: serving process failed ({proc.returncode}): "
        f"{proc.stderr[-4000:]}",
    )
    served = json.loads(proc.stdout.strip().splitlines()[-1])
    require(
        served["model_modules"] == [],
        f"export: the serving process imported {served['model_modules']}",
    )
    rasters = np.load(workdir / "export" / "served.npz")
    records, failures = {}, []
    for name in artifacts:
        front, precision = name.split("_")
        report = served[name]
        want = {"na2d_fwd": 3}
        if front == "transformer":
            want["temporal_fwd"] = 3
            want["layer_norm_rows"] = 7
        if report["launches_per_call"] != want:
            failures.append(f"{name}: a call launched {report['launches_per_call']}")
        if (
            report["graph_calls_na2d"] != 3
            or report["graph_calls_temporal"] != want.get("temporal_fwd", 0)
            or report["graph_calls_layer_norm"]
            != want.get("layer_norm_rows", 0)
            or report["kernels"] != "cuda"
        ):
            failures.append(f"{name}: graph {report}")
        outputs, inprocess_chips_per_s, repeat = inprocess_predict(
            models[front], precision, x, norm
        )
        err = max(
            float(np.abs(rasters[f"{name}/{band}"]
                         - outputs[band].cpu().numpy()).max())
            for band in ("distance", "edge", "crop")
        )
        limit = 1e-5 if precision == "fp32" else 2e-2
        if not err <= limit:
            failures.append(f"{name}: served vs in-process {err} > {limit}")
        records[name] = {
            **exports[name],
            **report,
            "served_vs_inprocess_max_abs": err,
            "limit": limit,
            "inprocess_chips_per_s": inprocess_chips_per_s,
            "inprocess_repeat_max_abs_default_cudnn": repeat,
        }
    del models
    torch.cuda.empty_cache()
    emit(
        {
            "phase": "export",
            "input": [EXPORT_BATCH, 12, 140, 140, 3],
            "serving_process_s": subprocess_s,
            "artifacts": records,
        }
    )
    require(not failures, f"export: {failures}")


def phase_transfer(fit_result: dict, workdir) -> None:
    """The rest of single-card ``train`` at full width on the fit phase's
    chips: ``fit_transfer`` from the fit's store for 1 epoch with
    ``finetune=None`` (fresh heads) then ``"fc"``: the backbone parameters
    equal the pretrained ``last`` bit for bit, the heads and the BatchNorm
    running statistics moved; per train step 3 na2d_fwd_drop and 3
    na2d_bwd_drop, per validation batch 3 na2d_fwd. Then ``lr_find`` over
    20 steps: strictly rising learning rates, a suggestion or a recorded
    divergence, the step's launches. Then a 1-epoch fit with
    ``model_pruning``: each pruned parameter (2 or more dimensions, 32 or
    more entries) holds at least int(0.2 n) zeros. Then a 1-epoch RAdam
    fit: finite losses."""
    from cultionet_tpu_torch.model import fit, fit_transfer
    from cultionet_tpu_torch.train.fit import FINAL_NAMES
    from cultionet_tpu_torch.train.lr_finder import lr_find
    from cultionet_tpu_torch.train.prune import sparsity

    root, norm, store = fit_result["root"], fit_result["norm"], fit_result["store"]
    pretrained = torch.load(store / "last" / "model.pt", weights_only=True)
    record = {"phase": "transfer"}
    for finetune in (None, "fc"):
        params = fit_params(
            root, workdir / f"transfer_{finetune}", norm, epochs=1,
            finetune=finetune,
        )
        params.pretrained_ckpt = store
        zero_launches()
        start = time.perf_counter()
        result = fit_transfer(params)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = read_launches()
        require(
            launches == fit_launches(4, 1),
            f"transfer {finetune}: launched {launches}",
        )
        got = result.state.model.state_dict()
        params_names = dict(result.state.model.named_parameters())
        heads_moved = stats_moved = False
        for name, value in pretrained["params"].items():
            final = any(p in FINAL_NAMES for p in name.split("."))
            same = torch.equal(got[name].cpu(), value)
            require(final or same, f"transfer {finetune}: {name} moved")
            heads_moved |= final and not same
        for name, value in pretrained["batch_stats"].items():
            if "running_" in name and name not in params_names:
                stats_moved |= not torch.equal(got[name].cpu(), value)
        require(heads_moved and stats_moved,
                f"transfer {finetune}: heads {heads_moved} stats {stats_moved}")
        require(all(np.isfinite(r["loss"]) for r in result.history),
                f"transfer {finetune}: {result.history}")
        record[f"finetune_{finetune}"] = {
            "seconds": seconds, "launches": launches,
            "history": result.history,
        }
        del result

    params = fit_params(root, workdir / "lr_find", norm, epochs=1)
    zero_launches()
    start = time.perf_counter()
    sweep = lr_find(params, num_steps=20)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - start
    launches = read_launches()
    steps = len(sweep.lrs)
    require(
        all(a < b for a, b in zip(sweep.lrs, sweep.lrs[1:]))
        and (sweep.suggestion is not None or steps < 20)
        and launches == fit_launches(steps, 0),
        f"lr_find: {steps} steps, suggestion {sweep.suggestion}, "
        f"launches {launches}",
    )
    record["lr_find"] = {
        "steps": steps, "seconds": sweep_s, "suggestion": sweep.suggestion,
        "lrs": sweep.lrs, "smoothed": sweep.losses, "launches": launches,
    }

    pruned = fit(fit_params(root, workdir / "pruned", norm, epochs=1,
                            model_pruning=True))
    counts = {}
    for name, value in pruned.state.model.named_parameters():
        if value.dim() >= 2 and value.numel() >= 32:
            zeros = int((value == 0).sum())
            require(zeros >= int(0.2 * value.numel()),
                    f"pruning: {name} {zeros} zeros of {value.numel()}")
            counts[name] = zeros
    record["pruning"] = {
        "sparsity": sparsity(dict(pruned.state.model.named_parameters())),
        "pruned_tensors": len(counts),
    }
    del pruned

    radam = fit(fit_params(root, workdir / "radam", norm, epochs=1,
                           optimizer="RAdam"))
    require(all(np.isfinite(r["loss"]) and np.isfinite(r["val_loss"])
                for r in radam.history), f"RAdam: {radam.history}")
    record["radam_history"] = radam.history
    del radam
    emit(record)


def field_chip(size: int = 100, field: int = 20):
    """A seeded 100 x 100, T = 12, 3-band chip with a field layout: a grid
    of 20-px fields, each ringed by a 1-px edge (class 2); about 70% of
    them crop (class 1), the rest background."""
    from cultionet_tpu_torch.data.batch import Batch

    rng = np.random.default_rng(5)
    y = np.zeros((size, size), dtype=np.int32)
    for r in range(0, size, field):
        for c in range(0, size, field):
            y[r : r + field, c : c + field] = 2
            if rng.random() < 0.7:
                y[r + 1 : r + field - 1, c + 1 : c + field - 1] = 1
            else:
                y[r + 1 : r + field - 1, c + 1 : c + field - 1] = 0
    return Batch(
        x=torch.from_numpy(rng.random((1, 12, size, size, 3), dtype=np.float32)),
        y=torch.from_numpy(y[None]),
        bdist=torch.from_numpy(rng.random((1, size, size), dtype=np.float32)),
    )


def augmenter_ms(batch, samples: int = 21) -> dict:
    """Median host ms a sample of each of the 14 augmenters (all but
    "none") on ``batch``, over ``samples`` calls, each with its own draws."""
    from cultionet_tpu_torch.augment import AUGMENTATION_NAMES, Augmenters

    times = {}
    for name in AUGMENTATION_NAMES:
        if name == "none":
            continue
        rng = np.random.default_rng(0)
        calls = []
        for _ in range(samples):
            start = time.perf_counter()
            out = Augmenters([name], rng=rng)(batch)
            calls.append((time.perf_counter() - start) * 1e3)
            require(
                out.x.shape == batch.x.shape and bool(torch.isfinite(out.x).all()),
                f"augmenter {name}: output {out.x.shape}",
            )
        times[name] = statistics.median(calls)
    return times


def phase_fit_augment(fit_result: dict) -> None:
    """The CLI default, host augmentation at augment_prob 0.5, over the fit
    phase's 20 chips: 2 epochs with checkpoints, then a resume to 3 (one
    epoch's time is the difference); the loader alone over the first two
    epochs' loading with augmentation off and on; each augmenter's host
    time on a field-layout chip."""
    from cultionet_tpu_torch.augment import label_segments
    from cultionet_tpu_torch.model import fit

    root, norm = fit_result["root"], fit_result["norm"]
    ckpt = root.parent / "ckpt_augment"
    runs = {}
    for epochs, steps, val_batches in ((2, 8, 2), (3, 4, 1)):
        zero_launches()
        start = time.perf_counter()
        result = fit(fit_params(root, ckpt, norm, epochs, augment_prob=0.5))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = read_launches()
        require(
            launches == fit_launches(steps, val_batches),
            f"fit_augment ({epochs} epochs) launched {launches}",
        )
        for row in result.history:
            for key in ("loss", "val_loss", "val_score"):
                require(np.isfinite(row[key]), f"fit_augment: {key} {row}")
        runs[epochs] = (seconds, launches, result.history)
        del result
    for which in ("last", "best"):
        require(
            (ckpt / "last_store" / which / "model.pt").exists(),
            f"fit_augment: no {which}",
        )
    epoch_s = runs[2][0] - runs[3][0]

    # The loader alone over the 2-epoch runs' loading, augmentation off
    # and on, in turns.
    loader = {0.0: [], 0.5: []}
    for prob in (0.0, 0.5, 0.5, 0.0):
        loader[prob].append(loader_s(root, norm, prob, epochs=2))
    parcels = []
    for path in sorted((root / "processed").glob("*.npz")):
        with np.load(path) as data:
            parcels.append(int(label_segments(data["y"][0]).max()))
    chip = field_chip()
    emit(
        {
            "phase": "fit_augment",
            "chips": [FIT_CHIPS, 12, 100, 100, 3],
            "augment_prob": 0.5,
            "precision": "16-mixed",
            "fit_2_epochs_s": runs[2][0],
            "fit_resumed_1_epoch_s": runs[3][0],
            "epoch_s": epoch_s,
            "epoch_train_chips_per_s": 16 / epoch_s,
            "epoch_train_chips_per_s_augment_0": fit_result[
                "epoch_train_chips_per_s"
            ],
            "fit_2_epochs_s_augment_0": fit_result["fit_2_epochs_s"],
            "loader_2_epochs_s_augment_0": loader[0.0],
            "loader_2_epochs_s_augment_0.5": loader[0.5],
            "fit_chip_parcels": [min(parcels), max(parcels)],
            "field_chip_parcels": int(label_segments(chip.y[0].numpy()).max()),
            "augmenter_ms_field_chip": augmenter_ms(chip),
            "history": runs[2][2] + runs[3][2],
            "launches": runs[2][1],
            "resumed_launches": runs[3][1],
        }
    )


def phase_predict_raster(fit_result: dict) -> None:
    """Predict over chip files to a GeoTIFF with the fit phase's ``best``
    checkpoint: the seeded 420 x 420 int16 scene -> create_predict_dataset
    (window 100, padding 20: 25 chips) -> ChipDataset -> predict_to_raster
    at bf16, batch 8; the raster read back against its sidecar; the
    chip-file raster at fp32 against predict_scene on the same scene."""
    from cultionet_tpu_torch.data.create import (
        create_predict_dataset,
        prepare_image_time_series,
    )
    from cultionet_tpu_torch.data.datasets import ChipDataset
    from cultionet_tpu_torch.data.tiny_tiff import read_tiff
    from cultionet_tpu_torch.model import load_model
    from cultionet_tpu_torch.predict import ScenePredictor

    workdir = fit_result["root"].parent / "predict"
    scene = (
        np.random.default_rng(0).random((12, 420, 420, 3)) * 10000.0
    ).astype("int16")
    bounds = (500000.0, 4000000.0, 504200.0, 4004200.0)  # 10 m cells
    start = time.perf_counter()
    paths = create_predict_dataset(
        scene, region="smoke", process_path=workdir / "processed",
        window_size=100, padding=20, bounds=bounds,
    )
    create_s = time.perf_counter() - start
    require(len(paths) == 25, f"predict_raster: {len(paths)} chips")
    dataset = ChipDataset(workdir)

    _, model = load_model(fit_result["store"], "best")
    predictor = ScenePredictor(model, batch_size=8, precision="bf16", device="cuda")
    predictor.predict_windows(dataset)  # warm-up
    zero_launches()
    start = time.perf_counter()
    raster, (h, w) = predictor.predict_windows(dataset)
    windows_s = time.perf_counter() - start
    windows_launches = read_launches()
    require(raster.shape == (420, 420, 3), f"predict_raster: {raster.shape}")
    require(bool(np.isfinite(raster).all()), "predict_raster: not finite")

    zero_launches()
    start = time.perf_counter()
    out = predictor.predict_to_raster(
        dataset, workdir / "out" / "smoke.tif", crs="EPSG:32633"
    )
    to_raster_s = time.perf_counter() - start
    launches = read_launches()
    want = {name: 0 for name in launches}
    want["na2d_fwd"] = 12
    for got in (windows_launches, launches):
        require(got == want, f"predict_raster launched {got}, want {want}")

    bands, read_bounds, res, crs = read_tiff(out)
    with np.load(out.with_suffix(".npz")) as sidecar:
        packed = sidecar["raster"]
        side_bounds = tuple(sidecar["bounds"])
        transform = tuple(sidecar["transform"])
        side_crs = str(sidecar["crs"])
    require(bands.shape == (3, 420, 420), f"predict_raster tiff {bands.shape}")
    for band in range(3):
        require(
            np.array_equal(bands[band], packed[band]),
            f"predict_raster: band {band} differs from the sidecar",
        )
    want_bounds = tuple(float(np.float32(v)) for v in bounds)
    require(
        side_bounds == want_bounds
        and np.allclose(read_bounds, want_bounds, rtol=0, atol=1e-6),
        f"predict_raster bounds {read_bounds} / {side_bounds}",
    )
    left, bottom, right, top = want_bounds
    want_transform = ((right - left) / 420, 0.0, left, 0.0, -(top - bottom) / 420, top)
    require(transform == want_transform, f"predict_raster transform {transform}")
    require(res == want_transform[0], f"predict_raster cell size {res}")
    require(crs == side_crs == "EPSG:32633", f"predict_raster crs {crs}")

    # fp32: the chip-file path against the in-memory path, no NormValues.
    predictor = ScenePredictor(model, batch_size=8, precision="fp32", device="cuda")
    from_files, _ = predictor.predict_windows(dataset)
    in_memory, _ = predictor.predict_scene(
        prepare_image_time_series(scene), window_size=100, padding=20
    )
    err = float(np.abs(from_files - in_memory).max())
    require(err <= 1e-4, f"predict_raster: files vs scene max-abs {err}")
    emit(
        {
            "phase": "predict_raster",
            "scene": [12, 420, 420, 3],
            "windows": 25,
            "precision": "bf16",
            "create_predict_dataset_s": create_s,
            "predict_windows_s": windows_s,
            "windows_per_s": 25 / windows_s,
            "predict_to_raster_s": to_raster_s,
            "raster_write_s": to_raster_s - windows_s,
            "files_vs_scene_fp32_max_abs": err,
            "tiff_bytes": out.stat().st_size,
            "launches": launches,
        }
    )
    del model, predictor


CLI_REGIONS = 20  # 100 x 100, T = 12, 3 bands, 16-25 fields each
CLI_BOUNDS = (500000.0, 4000000.0, 504200.0, 4004200.0)  # the 420^2 region


def field_layout(rng, bounds, size: int = 100, cell_res: float = 10.0):
    """[ring, class] pairs in world coordinates for one region: a 4 x 4 to
    5 x 5 grid of fields (class 1), each a jittered quadrilateral 3-6 px
    inside its grid cell; about a quarter concave (a notch cut into one
    side), about one in seven with a hole (reached through a zero-width
    slit, the hole's ring inside the field's one ring); the fields of the
    outer rows and columns run 4 px past the scene's edge."""
    left, _, _, top = bounds
    rows, cols = [(4, 4), (4, 5), (5, 4), (5, 5)][int(rng.integers(0, 4))]
    ys, xs = np.linspace(0, size, rows + 1), np.linspace(0, size, cols + 1)
    shapes = []
    for i in range(rows):
        for j in range(cols):
            r0 = ys[i] + 1.5 + rng.uniform(0, 1.5) - 4 * (i == 0)
            r1 = ys[i + 1] - 1.5 - rng.uniform(0, 1.5) + 4 * (i == rows - 1)
            c0 = xs[j] + 1.5 + rng.uniform(0, 1.5) - 4 * (j == 0)
            c1 = xs[j + 1] - 1.5 - rng.uniform(0, 1.5) + 4 * (j == cols - 1)
            corners = [
                (r + rng.uniform(-1.2, 1.2), c + rng.uniform(-1.2, 1.2))
                for r, c in ((r0, c0), (r0, c1), (r1, c1), (r1, c0))
            ]
            kind = rng.random()
            ring = list(corners)
            if kind < 0.25:
                rm, cm = (r0 + r1) / 2, c1 - 0.4 * (c1 - c0)
                ring[2:2] = [(rm - 2, c1), (rm, cm), (rm + 2, c1)]
            ring.append(ring[0])
            if 0.25 <= kind < 0.4:
                hr = (r0 + 0.35 * (r1 - r0), r0 + 0.65 * (r1 - r0))
                hc = (c0 + 0.35 * (c1 - c0), c0 + 0.65 * (c1 - c0))
                hole = [(hr[0], hc[0]), (hr[1], hc[0]), (hr[1], hc[1]),
                        (hr[0], hc[1]), (hr[0], hc[0])]
                ring += hole + [ring[0]]
            shapes.append(
                [[[left + c * cell_res, top - r * cell_res] for r, c in ring], 1]
            )
    return shapes


def write_field_region(region, rng, bounds) -> int:
    """One region of 12 x 100 x 100 x 3 int16 x 10000 at 10 m cells
    (scene.npz) with a field layout (polygons.json); returns its field
    count."""
    region.mkdir(parents=True)
    np.savez(
        region / "scene.npz",
        x=(rng.random((12, 100, 100, 3)) * 10000).astype("int16"),
        bounds=np.asarray(bounds), cell_res=np.asarray(10.0),
        crs=np.asarray("EPSG:32633"),
    )
    shapes = field_layout(rng, bounds)
    (region / "polygons.json").write_text(json.dumps(shapes))
    return len(shapes)


def write_cli_project(project) -> list:
    """A seeded project of CLI_REGIONS regions ``rNN`` (scene.npz of 12 x
    100 x 100 x 3 int16 x 10000 at 10 m cells, and polygons.json with a
    field layout) and one 420 x 420 region ``predict`` (no polygons);
    returns each region's field count."""
    rng = np.random.default_rng(31)
    fields = []
    for k in range(CLI_REGIONS):
        bounds = (600000.0 + 2000.0 * k, 4100000.0, 601000.0 + 2000.0 * k, 4101000.0)
        region = project / "time_series_vars" / f"r{k:02d}"
        fields.append(write_field_region(region, rng, bounds))
    region = project / "time_series_vars" / "predict"
    region.mkdir(parents=True)
    np.savez(
        region / "scene.npz",
        x=(rng.random((12, 420, 420, 3)) * 10000).astype("int16"),
        bounds=np.asarray(CLI_BOUNDS), cell_res=np.asarray(10.0),
        crs=np.asarray("EPSG:32633"),
    )
    return fields


def served_windows_raster(predictor, artifact, dataset) -> np.ndarray:
    """The blended raster of ``dataset``'s window chips with ``predictor``'s
    step replaced by the served artifact: each batch of scaled chips goes
    back to the int16 wire format, padded to the artifact's batch."""
    from cultionet_tpu_torch.export import load_predictor
    from cultionet_tpu_torch.predict import BAND_NAMES

    served = load_predictor(artifact)
    size = served.batch_size

    def padded(values, n):
        out = torch.zeros(size, device="cuda")
        out[:n] = torch.as_tensor(values, device="cuda")
        return out

    def step(x, lat, lon):
        n = x.shape[0]
        wire = torch.zeros((size, *x.shape[1:]), dtype=torch.int16,
                           device="cuda")
        wire[:n] = torch.round(x * 10000.0).to(torch.int16)
        outs = served.call_on_device(wire, padded(lat, n), padded(lon, n))
        return {band: out[:n] for band, out in zip(BAND_NAMES, outs)}

    predictor.predict_step = step
    return predictor.predict_windows(dataset)[0]


def partition_train(project, workdir, cli) -> dict:
    """``train --spatial-partitions FILE --partition-name east --epochs 1``
    on a copy of the project's chips and norm statistics: the GeoJSON names
    two polygons, west over regions r00-r09 and east over r10-r19; 10
    chips train (2 steps of 4) and 10 validate (3 batches)."""
    import shutil

    other = workdir / "cli_partitions"
    shutil.copytree(project / "data", other / "data")
    (other / "ckpt").mkdir(parents=True)
    shutil.copy(project / "ckpt" / "last.norm.npz", other / "ckpt")

    def box(x0, x1):
        y0, y1 = 4099000.0, 4102000.0
        return [[x0, y0], [x1, y0], [x1, y1], [x0, y1], [x0, y0]]

    parts = workdir / "partitions.geojson"
    parts.write_text(json.dumps({"type": "FeatureCollection", "features": [
        {"type": "Feature", "properties": {"name": name},
         "geometry": {"type": "Polygon", "coordinates": [box(x0, x1)]}}
        for name, x0, x1 in (("west", 599000.0, 619500.0),
                             ("east", 619500.0, 640000.0))
    ]}))
    zero_launches()
    cli(["train", "-p", str(other), "--spatial-partitions", str(parts),
         "--partition-name", "east", "--epochs", "1"])
    launches = read_launches()
    require(launches == fit_launches(2, 3),
            f"cli train with partitions launched {launches}")
    return launches


def orientation_s_per_chip(chips) -> float:
    """Seconds the orientation takes in one chip's label math: the Sobel
    and the phase of ``create_boundary_distances`` on each created chip's
    crop mask (the median over the chips)."""
    from cultionet_tpu_torch.data import label_math

    times = []
    for path in chips:
        with np.load(path) as data:
            y = data["y"][0]
        bdist = label_math.chamfer_distance(((y > 0) & (y != 2)).astype(np.uint8))
        start = time.perf_counter()
        grad_x, grad_y = label_math.sobel_5(np.pad(bdist, 5, mode="edge"))
        np.mod(np.arctan2(grad_y, grad_x), 2 * np.pi)
        times.append(time.perf_counter() - start)
    return statistics.median(times)


def phase_cli(workdir) -> None:
    """The port's command line in-process (``scripts/cli.py::main``) at the
    CLI defaults (hidden 64, natten, dropout 0.2, augment_prob 0.5, batch 4,
    "16-mixed"), on a project of field-layout regions: ``create``; ``train
    --skip-train`` (the normalization statistics and the model build);
    ``train --epochs 2`` then a resume to 3; 2-epoch ``model.fit`` runs at
    augment_prob 0.0 and 0.5 in turns; ``create-predict --window-size 100
    --padding 20`` of the 420^2 region; ``predict`` to a GeoTIFF; then
    ``python -m cultionet_tpu_torch version`` in a subprocess. The loader
    alone over the 2-epoch fit's loading at augment_prob 0.0 and 0.5, in
    turns; the CLI's raster against ``predict_to_raster`` through the API
    on the same checkpoint and chips. Then ``train-transfer`` for 1 epoch;
    ``export`` (bf16, batch 8, 140-px windows) and the region's window
    chips served through the artifact, the blended raster within 2e-2 of
    ``predict``'s; and ``train --spatial-partitions FILE --partition-name
    east`` on a copy of the chips."""
    from cultionet_tpu_torch import __version__
    from cultionet_tpu_torch.augment import label_segments
    from cultionet_tpu_torch.data.datasets import ChipDataset
    from cultionet_tpu_torch.data.tiny_tiff import read_tiff
    from cultionet_tpu_torch.model import fit, load_model
    from cultionet_tpu_torch.predict import ScenePredictor
    from cultionet_tpu_torch.scripts.cli import main as cli
    from cultionet_tpu_torch.utils.normalize import NormValues

    project = workdir / "cli_project"
    fields = write_cli_project(project)
    p = ["-p", str(project)]
    regions = [f"r{k:02d}" for k in range(CLI_REGIONS)]

    start = time.perf_counter()
    cli(["create", *p, "--regions", *regions])
    create_s = time.perf_counter() - start
    chips = sorted((project / "data" / "train" / "processed").glob("*.npz"))
    require(len(chips) == CLI_REGIONS, f"cli create wrote {len(chips)} chips")
    parcels = []
    for path in chips:
        with np.load(path) as data:
            parcels.append(int(label_segments(data["y"][0]).max()))
    require(
        all(16 <= n <= 25 for n in parcels) and parcels == fields,
        f"cli create: parcels {parcels}, fields {fields}",
    )

    # The first train of a project computes its normalization statistics;
    # --skip-train does that and builds the model, so the 2-epoch run
    # below holds the epochs' work and the resumed run's is subtracted.
    zero_launches()
    start = time.perf_counter()
    cli(["train", *p, "--skip-train"])
    train_setup_s = time.perf_counter() - start
    launches = read_launches()
    require(
        not any(launches.values())
        and (project / "ckpt" / "last.norm.npz").is_file()
        and not (project / "ckpt" / "last_store" / "last").exists(),
        f"cli train --skip-train: launched {launches}",
    )
    runs = {}
    for epochs, steps, val_batches in ((2, 8, 2), (3, 4, 1)):
        zero_launches()
        start = time.perf_counter()
        cli(["train", *p, "--epochs", str(epochs)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = read_launches()
        require(
            launches == fit_launches(steps, val_batches),
            f"cli train ({epochs} epochs) launched {launches}",
        )
        runs[epochs] = (seconds, launches)
    store = project / "ckpt" / "last_store"
    for which in ("last", "best"):
        require((store / which / "model.pt").exists(), f"cli train: no {which}")
    rows = (project / "ckpt" / "history.csv").read_text().splitlines()
    history = [
        {k: float(v) for k, v in zip(rows[0].split(","), r.split(","))}
        for r in rows[1:]
    ]
    require(
        [r["epoch"] for r in history] == [0, 1, 2]
        and all(np.isfinite(list(r.values())).all() for r in history),
        f"cli train: history {history}",
    )
    epoch_s = runs[2][0] - runs[3][0]
    norm = NormValues.from_file(project / "ckpt" / "last.norm.npz")

    # The price of augment_prob 0.5 on these chips: 2-epoch fits from
    # scratch through the API (the CLI's training defaults, ``fit_params``)
    # at 0.0 and 0.5 in turns, each into a fresh checkpoint directory.
    fits = {0.0: [], 0.5: []}
    for turn, prob in enumerate((0.0, 0.5, 0.5, 0.0)):
        zero_launches()
        start = time.perf_counter()
        fit(fit_params(project / "data" / "train", workdir / f"cli_fit_{turn}",
                       norm, 2, augment_prob=prob))
        torch.cuda.synchronize()
        fits[prob].append(time.perf_counter() - start)
        launches = read_launches()
        require(
            launches == fit_launches(8, 2),
            f"cli fit at {prob} launched {launches}",
        )
    loader = {0.0: [], 0.5: []}
    for prob in (0.0, 0.5, 0.5, 0.0):
        loader[prob].append(loader_s(project / "data" / "train", norm, prob, 2))

    start = time.perf_counter()
    cli(["create-predict", *p, "--regions", "predict", "--window-size", "100",
         "--padding", "20"])
    create_predict_s = time.perf_counter() - start
    windows = sorted((project / "data" / "predict" / "processed").glob("*.npz"))
    require(len(windows) == 25, f"cli create-predict wrote {len(windows)} chips")

    out = project / "out" / "predict.tif"
    zero_launches()
    start = time.perf_counter()
    cli(["predict", *p, "--region", "predict", "-o", str(out)])
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - start
    predict_launches = read_launches()
    want = {name: 0 for name in predict_launches}
    want["na2d_fwd"] = 12
    require(predict_launches == want, f"cli predict launched {predict_launches}")

    bands, read_bounds, res, crs = read_tiff(out)
    with np.load(out.with_suffix(".npz")) as sidecar:
        packed = sidecar["raster"]
        side_bounds = tuple(sidecar["bounds"])
        transform = tuple(sidecar["transform"])
    require(
        bands.shape == (3, 420, 420) and np.array_equal(bands, packed),
        f"cli predict: tiff {bands.shape} differs from its sidecar",
    )
    want_bounds = tuple(float(np.float32(v)) for v in CLI_BOUNDS)
    left, bottom, right, top = want_bounds
    require(
        side_bounds == want_bounds
        and np.allclose(read_bounds, want_bounds, rtol=0, atol=1e-6)
        and transform
        == ((right - left) / 420, 0.0, left, 0.0, -(top - bottom) / 420, top)
        and crs == "EPSG:32633",
        f"cli predict: bounds {read_bounds} / {side_bounds}, transform "
        f"{transform}, crs {crs}",
    )

    # The same checkpoint and chips through the API: equal bit for bit.
    _, model = load_model(store, "best")
    predictor = ScenePredictor(model, batch_size=8, device="cuda")
    dataset = ChipDataset(
        project / "data" / "predict", pattern="data_predict*", norm_values=norm
    )
    zero_launches()
    start = time.perf_counter()
    predictor.predict_windows(dataset)
    windows_s = time.perf_counter() - start
    start = time.perf_counter()
    api_out = predictor.predict_to_raster(
        dataset, project / "out" / "api.tif", crs="EPSG:32633"
    )
    to_raster_s = time.perf_counter() - start
    api_launches = read_launches()
    require(api_launches["na2d_fwd"] == 24, f"cli api predict {api_launches}")
    api_bands = read_tiff(api_out)[0]
    require(
        np.array_equal(api_bands, bands),
        "cli predict differs from predict_to_raster: "
        f"{int((api_bands != bands).sum())} values",
    )

    # train-transfer from the trained store into its own, 1 epoch.
    zero_launches()
    start = time.perf_counter()
    cli(["train-transfer", *p, "--epochs", "1"])
    torch.cuda.synchronize()
    transfer_s = time.perf_counter() - start
    transfer_launches = read_launches()
    require(
        transfer_launches == fit_launches(4, 1)
        and (project / "ckpt" / "last_transfer_store" / "last" / "model.pt")
        .exists(),
        f"cli train-transfer launched {transfer_launches}",
    )

    # export the trained checkpoint (bf16, batch 8, 140-px windows) and
    # serve the region's window chips through it: the blended raster
    # within the bf16 gate of ``predict``'s.
    start = time.perf_counter()
    cli(["export", *p, "--chip-size", "140"])
    export_s = time.perf_counter() - start
    served = served_windows_raster(
        predictor, project / "ckpt" / "serve_best.cnx",
        ChipDataset(project / "data" / "predict", pattern="data_predict*"),
    )
    served_err = float(
        np.abs(np.moveaxis(served, -1, 0) - bands / 10000.0).max()
    )
    require(served_err <= 2e-2, f"cli export: served vs predict {served_err}")
    del model, predictor

    # train with a user partition file: validate on the "east" regions.
    partition_launches = partition_train(project, workdir, cli)

    version = subprocess.run(
        [sys.executable, "-m", "cultionet_tpu_torch", "version"],
        capture_output=True, text=True, timeout=300,
        cwd=Path(__file__).resolve().parent,
    )
    require(
        version.returncode == 0 and version.stdout.strip() == __version__,
        f"python -m cultionet_tpu_torch version: {version.returncode} "
        f"{version.stdout!r} {version.stderr[-2000:]!r}",
    )
    emit(
        {
            "phase": "cli",
            "chips": [CLI_REGIONS, 12, 100, 100, 3],
            "augment_prob": 0.5,
            "precision": "16-mixed",
            "create_s": create_s,
            "create_s_per_chip": create_s / CLI_REGIONS,
            "orientation_s_per_chip": orientation_s_per_chip(chips),
            "fields_per_chip": fields,
            "parcels_per_chip": parcels,
            "train_setup_s": train_setup_s,
            "fit_2_epochs_s": runs[2][0],
            "fit_resumed_1_epoch_s": runs[3][0],
            # 2-epoch run less the resumed run: holds the first run's
            # one-off costs and subtracts the restore. The in-turns fits
            # below are the phase's measure of an epoch at 0.0 and 0.5.
            "epoch_s_by_difference_incl_one_off": epoch_s,
            "epoch_train_chips_per_s_by_difference_incl_one_off": 16
            / epoch_s,
            "api_fit_2_epochs_s_augment_0": fits[0.0],
            "api_fit_2_epochs_s_augment_0.5": fits[0.5],
            "loader_2_epochs_s_augment_0": loader[0.0],
            "loader_2_epochs_s_augment_0.5": loader[0.5],
            "loader_share_of_fit_2_epochs_augment_0.5": max(loader[0.5])
            / min(fits[0.5]),
            "create_predict_s": create_predict_s,
            "predict_cli_s": predict_s,
            "predict_windows_s": windows_s,
            "windows_per_s": 25 / windows_s,
            "predict_to_raster_s": to_raster_s,
            "raster_write_s": to_raster_s - windows_s,
            "train_transfer_1_epoch_s": transfer_s,
            "train_transfer_launches": transfer_launches,
            "export_s": export_s,
            "served_vs_predict_max_abs": served_err,
            "partition_train_launches": partition_launches,
            "history": history,
            "launches": runs[2][1],
            "resumed_launches": runs[3][1],
            "predict_launches": predict_launches,
            "version": version.stdout.strip(),
        }
    )


OPTION_CONFIGS = [  # (label, model options over the CLI default)
    ("default", {}),
    ("O1", dict(res_block_type="res", attention_weights="spatial_channel")),
    ("O2", dict(res_block_type="res", attention_weights=None)),
    ("O3", dict(attention_weights="spatial_channel")),
    ("O4", dict(pool_by_max=True)),
    ("O5", dict(batchnorm_first=True)),
    ("O6", dict(use_latlon=True)),
    ("O7", dict(remat=True)),
    ("default_end", {}),  # the default again: host pace drifts over a run
]
OPTION_WARMUP = 2
OPTION_STEPS = 10
OPTION_COORDS = (  # (lat, lon) of 8 windows, and a second batch of them
    (np.linspace(-60.0, 60.0, 8), np.linspace(-150.0, 150.0, 8)),
    (np.linspace(10.0, 50.0, 8), np.linspace(-10.0, 30.0, 8)),
)


def option_model(options: dict, dropout: float = 0.2, seed: int = 0):
    """The CLI-default model at full width with ``options`` over it, its
    weights drawn from ``seed``."""
    from cultionet_tpu_torch.models import CultioNet
    from cultionet_tpu_torch.nn.init import init_parameters_

    model = CultioNet(
        in_time=12, in_channels=3, hidden_channels=64, dilations=[1, 2],
        dropout=dropout, activation_type="SiLU",
        **{"attention_weights": "natten", **options},
    )
    init_parameters_(model, torch.Generator().manual_seed(seed))
    return model


def option_step_launches(options: dict) -> dict:
    """NA launches of one "16-mixed" train step at dropout 0.2: the
    decoder's three dropout calls forward and backward with NATTEN (the
    recompute of remat runs the forward again), none without it."""
    want = {name: 0 for name in read_launches()}
    if options.get("attention_weights", "natten") == "natten":
        want["na2d_fwd_drop"] = 6 if options.get("remat") else 3
        want["na2d_bwd_drop"] = 3
    return want


def option_coords(which: int):
    """The ``which``-th (lat, lon) batch of OPTION_COORDS on the card."""
    return tuple(
        torch.tensor(values, dtype=torch.float32, device="cuda")
        for values in OPTION_COORDS[which]
    )


def option_train(options: dict, label: str, tf32: bool = False):
    """The timed "16-mixed" steps of one configuration: (state, record).
    With ``tf32`` also the rate with cuDNN's TF32 on (PyTorch's default;
    this script turns it off): where a model computes in fp32 on the
    card, as the fusion and the heads do under ``use_latlon``, that is
    what a user's run pays."""
    from torch.profiler import ProfilerActivity, profile

    from cultionet_tpu_torch.train.step import (
        create_train_state,
        make_train_step,
    )

    _, tx = train_setup(dropout=0.2)
    state = create_train_state(option_model(options), tx, device="cuda")
    step = make_train_step(
        loss_name="TanimotoComplementLoss", precision="16-mixed",
        device="cuda",
    )
    batch = train_batch().with_centroids().to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    losses = []
    for _ in range(OPTION_WARMUP):
        losses.append(step(state, batch, gen)[1]["loss"])
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    start = time.perf_counter()
    for _ in range(OPTION_STEPS):
        losses.append(step(state, batch, gen)[1]["loss"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(x) for x in losses]
    require(
        all(np.isfinite(losses)), f"model_options {label}: losses {losses}"
    )
    want = {
        k: OPTION_STEPS * n for k, n in option_step_launches(options).items()
    }
    require(
        launches == want,
        f"model_options {label}: train launched {launches}, want {want}",
    )
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(state, batch, gen)
        torch.cuda.synchronize()
    _, device_us, _ = device_time_by_kernel(prof, 1)
    steps_per_s = OPTION_STEPS / seconds
    extra = {}
    if tf32:
        torch.backends.cudnn.allow_tf32 = True
        try:
            step(state, batch, gen)
            torch.cuda.synchronize()
            start = time.perf_counter()
            for _ in range(OPTION_STEPS):
                step(state, batch, gen)
            torch.cuda.synchronize()
            tf32_s = time.perf_counter() - start
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                step(state, batch, gen)
                torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.allow_tf32 = False
        extra["train_chips_per_s_cudnn_tf32"] = 4 * OPTION_STEPS / tf32_s
        extra["step_device_ms_cudnn_tf32"] = (
            device_time_by_kernel(prof, 1)[1] / 1e3
        )
    return state, {
        **extra,
        "train_chips_per_s": 4 * steps_per_s,
        "train_steps_per_s": steps_per_s,
        "step_device_ms": device_us / 1e3,
        "step_device_idle_share": 1.0 - device_us / 1e6 * steps_per_s,
        "train_peak_memory_gib": peak,
        "train_launches": launches,
        "losses": losses,
    }


def option_predict(options: dict, label: str) -> dict:
    """One bf16 predict batch of 8 x 140^2 windows: its rate, its launches
    and, with NATTEN, the kernels against their plain version on the same
    bf16-valued windows: in fp32 within 1e-4 (phase ``model``'s gate);
    in bf16, where the network amplifies each side's rounding (the bf16
    plain forward and the kernels' differed by up to 0.0273 in one run),
    the kernels' forward lies within 2e-2 of the fp32 plain forward beyond
    the bf16 plain forward's own distance from it, as the kernel checks
    hold bf16 against the plain version in fp32. The model has seeded
    weights and BatchNorm statistics estimated by 20 training-mode passes
    over seeded windows, as ``build_model`` does and for its reason."""
    from cultionet_tpu_torch.nn.dropout import dropout_rng
    from cultionet_tpu_torch.ops import flags
    from cultionet_tpu_torch.train.step import make_predict_step

    gen = torch.Generator(device="cuda").manual_seed(1)
    lat, lon = option_coords(0)
    model = option_model(options).to("cuda").train()
    with torch.no_grad(), dropout_rng(gen):
        for _ in range(20):
            model(
                torch.rand(8, 12, 140, 140, 3, device="cuda", generator=gen),
                lat, lon,
            )
    model.eval()
    step = make_predict_step(model, "bf16", "cuda")
    x = torch.rand(8, 12, 140, 140, 3, device="cuda", generator=gen)
    x = x.bfloat16().float()
    step(x, lat, lon)  # warm-up
    zero_launches()
    start = time.perf_counter()
    outputs = step(x, lat, lon)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = read_launches()
    check_outputs(outputs, (8, 140, 140, 1), f"model_options {label}")
    natten = options.get("attention_weights", "natten") == "natten"
    want = {name: 0 for name in launches}
    want["na2d_fwd"] = 3 if natten else 0
    require(
        launches == want,
        f"model_options {label}: predict launched {launches}, want {want}",
    )
    record = {
        "predict_windows_per_s": 8 / seconds,
        "predict_launches": launches,
    }
    if natten:
        step32 = make_predict_step(model, "fp32", "cuda")
        kernel32 = step32(x, lat, lon)
        flags.set_cuda_natten(False)
        try:
            plain = step(x, lat, lon)
            plain32 = step32(x, lat, lon)
        finally:
            flags.set_cuda_natten(True)

        def max_abs(a, b):
            return max(
                (a[n] - b[n]).abs().max().item()
                for n in ("distance", "edge", "crop")
            )

        errors = {
            "kernel_vs_plain_fp32_max_abs": max_abs(kernel32, plain32),
            "kernel_vs_plain_bf16_max_abs": max_abs(outputs, plain),
            "kernel_bf16_vs_plain_fp32_max_abs": max_abs(outputs, plain32),
            "plain_bf16_vs_plain_fp32_max_abs": max_abs(plain, plain32),
        }
        require(
            errors["kernel_vs_plain_fp32_max_abs"] <= 1e-4
            and errors["kernel_bf16_vs_plain_fp32_max_abs"]
            <= errors["plain_bf16_vs_plain_fp32_max_abs"] + 2e-2,
            f"model_options {label}: kernel vs plain {errors}",
        )
        record.update(errors)
    return record


def option_card_vs_cpu(options: dict, label: str) -> dict:
    """An fp32 dropout-0 step's loss and gradients at batch 1 (1 x 44^2),
    on the card against the CPU, with train_parity's limits."""
    import copy

    from cultionet_tpu_torch.data.synthetic import create_batch

    model = option_model(options, dropout=0.0, seed=1)
    small = create_batch(
        num_channels=3, num_time=12, height=44, width=44, batch_size=1,
        rng=np.random.default_rng(1),
    ).with_centroids()
    card_loss, card_grads = loss_and_grads(copy.deepcopy(model), small, "cuda")
    cpu_loss, cpu_grads = loss_and_grads(model, small, "cpu")
    loss_err = abs(card_loss - cpu_loss)
    require(
        loss_err <= 1e-5, f"model_options {label}: card vs CPU loss {loss_err}"
    )
    return {
        "card_vs_cpu_loss_abs_diff": loss_err,
        **require_grads_close(
            f"model_options {label} card vs CPU", card_grads, cpu_grads
        ),
    }


def remat_against_plain() -> dict:
    """O7: one fp32 step at dropout 0.2 of the remat model against the
    plain model, from the same weights and generator seed, with cuDNN's
    deterministic algorithms: loss, gradients and running statistics
    within 1e-5, the generator's state after the step equal."""
    import copy

    from cultionet_tpu_torch.train.step import forward_loss

    base = option_model({}, seed=2)
    batch = train_batch().to("cuda")
    results = {}
    torch.backends.cudnn.deterministic = True
    try:
        for remat in (False, True):
            model = copy.deepcopy(base).to("cuda")
            model.mask_model.remat = remat
            gen = torch.Generator(device="cuda").manual_seed(3)
            zero_launches()
            loss, _ = forward_loss(
                model, batch, gen, torch.float32,
                loss_name="TanimotoComplementLoss",
            )
            loss.backward()
            launches = read_launches()
            results[remat] = (
                loss.item(),
                {n: p.grad for n, p in model.named_parameters()},
                dict(model.named_buffers()),
                gen.get_state(),
                launches,
            )
    finally:
        torch.backends.cudnn.deterministic = False
    (l0, g0, b0, s0, n0), (l1, g1, b1, s1, n1) = results[False], results[True]
    grad_err = max((g1[k] - v).abs().max().item() for k, v in g0.items())
    stats_err = max(
        (b1[k].float() - v.float()).abs().max().item() for k, v in b0.items()
    )
    record = {
        "loss": l0,
        "loss_abs_diff": abs(l1 - l0),
        "grad_max_abs_diff": grad_err,
        "running_stats_max_abs_diff": stats_err,
        "generator_state_equal": bool(torch.equal(s0, s1)),
        "launches_plain": n0,
        "launches_remat": n1,
    }
    require(
        abs(l1 - l0) <= 1e-5 and grad_err <= 1e-5 and stats_err <= 1e-5
        and record["generator_state_equal"]
        and n1["na2d_fwd_drop"] == 2 * n0["na2d_fwd_drop"] == 6,
        f"model_options O7: remat vs plain {record}",
    )
    return record


def remat_peak_memory() -> dict:
    """O7: peak device memory of one "16-mixed" step (after a warm-up
    step) with and without remat, at batch 4 and 16."""
    from cultionet_tpu_torch.data.synthetic import create_batch
    from cultionet_tpu_torch.train.step import (
        create_train_state,
        make_train_step,
    )

    step = make_train_step(
        loss_name="TanimotoComplementLoss", precision="16-mixed",
        device="cuda",
    )
    record = {}
    for batch_size in (4, 16):
        batch = create_batch(
            num_channels=3, num_time=12, height=100, width=100,
            batch_size=batch_size, rng=np.random.default_rng(0),
        ).to("cuda")
        for remat in (False, True):
            _, tx = train_setup(dropout=0.2)
            state = create_train_state(
                option_model({"remat": remat}), tx, device="cuda"
            )
            gen = torch.Generator(device="cuda").manual_seed(0)
            step(state, batch, gen)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            step(state, batch, gen)
            torch.cuda.synchronize()
            record[f"batch{batch_size}_{'remat' if remat else 'plain'}"] = {
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "step_gib_above_resident": (
                    torch.cuda.max_memory_allocated() - base
                ) / 2**30,
            }
            del state
            torch.cuda.empty_cache()
        plain = record[f"batch{batch_size}_plain"]["step_gib_above_resident"]
        remat = record[f"batch{batch_size}_remat"]["step_gib_above_resident"]
        record[f"batch{batch_size}_plain_over_remat"] = plain / remat
    return record


def latlon_export(model, workdir) -> dict:
    """O6: a bf16 artifact of the trained state at batch 8 x 140^2; served
    in process, with cuDNN's deterministic algorithms, it equals the eager
    serve program (0.0); two coordinate batches give different outputs."""
    from cultionet_tpu_torch.export import (
        build_serve_fn,
        export_state,
        load_predictor,
    )

    out = workdir / "model_options" / "latlon_bf16.cnx"
    start = time.perf_counter()
    export_state(
        model, out, in_time=12, in_channels=3, batch_size=EXPORT_BATCH,
        chip_size=140, precision="bf16",
    )
    export_s = time.perf_counter() - start
    served = load_predictor(out)
    serve = build_serve_fn(model, precision="bf16")
    wire = torch.from_numpy(
        np.random.default_rng(43).integers(
            0, 10000, size=(EXPORT_BATCH, 12, 140, 140, 3), dtype=np.int16
        )
    ).cuda()
    bands = ("distance", "edge", "crop")
    outputs = []
    torch.backends.cudnn.deterministic = True
    try:
        for which in (0, 1):
            lat, lon = option_coords(which)
            got = served.call_on_device(wire, lat, lon)
            with torch.inference_mode():
                want = serve(wire, lat, lon)
            err = max((g - w).abs().max().item() for g, w in zip(got, want))
            outputs.append((got, err))
    finally:
        torch.backends.cudnn.deterministic = False
    errors = [err for _, err in outputs]
    coords_effect = max(
        (a - b).abs().max().item()
        for a, b in zip(outputs[0][0], outputs[1][0])
    )
    require(
        errors == [0.0, 0.0] and coords_effect > 1e-4
        and all(v.dtype == torch.float32 for v in outputs[0][0]),
        f"model_options O6: served vs in-process {errors}, coordinates "
        f"moved the outputs by {coords_effect}",
    )
    return {
        "export_s": export_s,
        "artifact_bytes": out.stat().st_size,
        "served_vs_inprocess_max_abs": errors,
        "coordinate_batches_max_abs_diff": coords_effect,
        "outputs": list(bands),
    }


def cli_model_options(workdir) -> dict:
    """``train --pool-by-max --batchnorm-first --use-latlon --epochs 1``
    then ``predict`` on a copy of the cli phase's project (its chips,
    window chips and normalization statistics; no checkpoint)."""
    import shutil

    from cultionet_tpu_torch.data.tiny_tiff import read_tiff
    from cultionet_tpu_torch.scripts.cli import main as cli

    project = workdir / "cli_options_project"
    shutil.copytree(
        workdir / "cli_project", project,
        ignore=shutil.ignore_patterns(
            "*_store", "history.csv", "*.cnx", "out"
        ),
    )
    p = ["-p", str(project)]
    zero_launches()
    start = time.perf_counter()
    cli(["train", *p, "--pool-by-max", "--batchnorm-first", "--use-latlon",
         "--epochs", "1"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - start
    launches = read_launches()
    require(
        launches == fit_launches(4, 1),
        f"model_options cli train launched {launches}",
    )
    out = project / "out" / "options.tif"
    zero_launches()
    start = time.perf_counter()
    cli(["predict", *p, "--region", "predict", "-o", str(out)])
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - start
    predict_launches = read_launches()
    want = {name: 0 for name in predict_launches}
    want["na2d_fwd"] = 12
    bands = read_tiff(out)[0]
    require(
        predict_launches == want and bands.shape == (3, 420, 420),
        f"model_options cli predict launched {predict_launches}, raster "
        f"{bands.shape}",
    )
    return {
        "train_1_epoch_s": train_s,
        "train_launches": launches,
        "predict_s": predict_s,
        "predict_launches": predict_launches,
        "raster_shape": list(bands.shape),
    }


def phase_model_options(smi: str, workdir) -> None:
    records = {}
    for label, options in OPTION_CONFIGS:
        start = time.perf_counter()
        state, record = option_train(
            options, label, tf32=label in ("default", "O6", "default_end")
        )
        if label != "default_end":  # its weights and path: the default's
            record.update(option_predict(options, label))
        if options:
            record.update(option_card_vs_cpu(options, label))
        if label == "O6":
            record["export"] = latlon_export(state.model, workdir)
        del state
        torch.cuda.empty_cache()
        if label == "O7":
            record["remat_vs_plain"] = remat_against_plain()
            record["peak_memory"] = remat_peak_memory()
        record["options"] = options
        record["seconds"] = time.perf_counter() - start
        records[label] = record
        print(f"model_options {label}: {record['seconds']:.1f} s", flush=True)
    start = time.perf_counter()
    cli_record = cli_model_options(workdir)
    cli_record["seconds"] = time.perf_counter() - start
    default_rate = (
        records["default"]["train_chips_per_s"]
        + records["default_end"]["train_chips_per_s"]
    ) / 2
    emit(
        {
            "phase": "model_options",
            "card": smi,
            "train_batch": [4, 12, 100, 100, 3],
            "predict_batch": [8, 12, 140, 140, 3],
            "precision": {"train": "16-mixed", "predict": "bf16"},
            "timed_steps": OPTION_STEPS,
            "configs": records,
            "train_rate_over_default": {
                label: r["train_chips_per_s"] / default_rate
                for label, r in records.items()
            },
            "cli": cli_record,
        }
    )


DATA_REGIONS = 40  # field-layout chips: 32 train and 8 validation (val_frac 0.2)
DATA_STEPS, DATA_VAL_BATCHES = 8, 2  # an epoch at batch 4
DATA_FITS = [  # (label, fit options): each mode of the device data path
    ("host_augment_0", {}),
    ("host_augment_0.5", {"augment_prob": 0.5}),
    ("stream", {"use_chipstore": "stream"}),
    ("hbm", {"use_chipstore": "hbm"}),
    ("hbm_device_augment", {
        "use_chipstore": "hbm", "device_augment": True,
        "device_augment_noise": 0.01,
    }),
]


def created_records(path) -> dict:
    """A created chip's int16 x 10000 records, by the packing rule written
    out: x and bdist (float32 in [0, 1]) scaled by 10000 and rounded, y as
    int16."""
    with np.load(path) as data:
        return {
            "x": np.round(data["x"] * np.float32(10000)).astype(np.int16),
            "y": data["y"].astype(np.int16),
            "bdist": np.round(data["bdist"] * np.float32(10000)).astype(np.int16),
        }


def require_equal_records(batch, want: dict, label: str) -> None:
    for name, value in want.items():
        got = getattr(batch, name).cpu().numpy()
        require(
            got.dtype == np.int16 and np.array_equal(got, value),
            f"{label}: {name} differs from the chips' records",
        )


def data_store(dataset, path) -> dict:
    """Build the phase's v2 chipstore of ``dataset``; read_batch of every
    chip equals the chips' records bit for bit. Returns the records by
    chip longitude (unique per region) and the store's path."""
    from cultionet_tpu_torch.data import chipstore

    start = time.perf_counter()
    path = chipstore.build_chipstore_from_dataset(dataset, path)
    write_s = time.perf_counter() - start
    records = [created_records(f) for f in dataset.files]
    want = {k: np.concatenate([r[k] for r in records]) for k in records[0]}
    with chipstore.ChipStore(path) as store:
        require(
            store.packed and store.num_chips == len(dataset.files),
            f"device_data: store version {store.version}, {store.num_chips} chips",
        )
        every = store.read_batch(range(store.num_chips))
    require_equal_records(every, want, "device_data read_batch")
    by_lon = {float(lon): i for i, lon in enumerate(every.lon.tolist())}
    require(len(by_lon) == len(dataset.files), "device_data: chip lons collide")
    return {"path": path, "by_lon": by_lon, "want": want, "write_s": write_s,
            "bytes": path.stat().st_size}


def stream_epochs(dataset, store: dict) -> dict:
    """Two epochs of ChipstoreLoader on the card (4 threads, pinned ring;
    the first allocates the ring's buffers): the second's batches hold
    every train chip once, each equal to the records of its chips; then an
    epoch's batches copied from the slots synchronously from pageable
    memory, for the time."""
    from cultionet_tpu_torch.data import chipstore

    loader = chipstore.ChipstoreLoader(
        dataset, batch_size=4, cache_path=store["path"].with_name("train.cts"),
        seed=42, num_threads=4, device="cuda",
    )
    require(loader.path == store["path"], "device_data: loader built a new store")
    pinned_s = []
    for _ in range(2):  # the first epoch also allocates the ring's buffers
        start = time.perf_counter()
        batches = list(loader)
        torch.cuda.synchronize()
        pinned_s.append(time.perf_counter() - start)
    seen = []
    for batch in batches:
        require(batch.x.is_cuda and batch.x.dtype == torch.int16,
                f"device_data stream: x {batch.x.dtype} on {batch.x.device}")
        idx = [store["by_lon"][float(v)] for v in batch.lon.cpu().tolist()]
        seen += idx
        require_equal_records(
            batch, {k: v[idx] for k, v in store["want"].items()},
            "device_data stream",
        )
    require(
        len(batches) == DATA_STEPS and sorted(seen) == list(range(len(dataset.files))),
        f"device_data stream: epoch of {len(batches)} batches, chips {sorted(seen)}",
    )
    start = time.perf_counter()
    with chipstore.ChipStore(store["path"]) as reader:
        for batch in reader.iter_prefetched(
            4, seed=43, num_threads=4, num_batches=DATA_STEPS, copy=False
        ):
            for value in batch.tensors().values():
                value.to("cuda")
    torch.cuda.synchronize()
    pageable_s = time.perf_counter() - start
    return {"stream_epoch_s_pinned_ring": pinned_s,
            "stream_epoch_s_pageable_sync": pageable_s}


def resident_split(dataset, store: dict) -> dict:
    """A DeviceChipCache on the card: its upload, bytes against the
    estimate, device memory before and after, and gather_batch equal to
    the host stack of the records bit for bit."""
    from cultionet_tpu_torch.data.device_cache import (
        DeviceChipCache,
        estimate_cache_bytes,
        gather_batch,
        hbm_budget_bytes,
    )

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    start = time.perf_counter()
    cache = DeviceChipCache(dataset, batch_size=4, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - start
    after = torch.cuda.memory_allocated()
    estimate = estimate_cache_bytes(len(dataset.files), 12, 100, 100, 3)
    require(
        cache.resident_bytes == estimate and after - before >= estimate,
        f"device_data: resident {cache.resident_bytes}, estimate {estimate}, "
        f"allocated {after - before}",
    )
    idx = torch.tensor([5, 0, 31, 5], device="cuda")
    batch = gather_batch(cache.arrays, idx)
    require_equal_records(
        batch, {k: v[[5, 0, 31, 5]] for k, v in store["want"].items()},
        "device_data gather",
    )
    start = time.perf_counter()
    for index_batch in cache:
        gather_batch(cache.arrays, index_batch.indices)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - start
    return {
        "resident_build_s": build_s,
        "resident_bytes": cache.resident_bytes,
        "estimate_cache_bytes": estimate,
        "memory_allocated_before": before,
        "memory_allocated_after": after,
        "hbm_budget_bytes": hbm_budget_bytes(device="cuda"),
        "resident_epoch_gather_s": epoch_s,
    }


def device_augment_checks() -> dict:
    """The 8 dihedral codes on the card against the CPU bit for bit on a
    CLI-size batch; over 4,096 draws on the card the codes pass a
    chi-square test at p > 1e-3, and the noise has mean within 3 sigma /
    sqrt(n) of 0 and std within 2% of sigma."""
    from scipy import stats

    from cultionet_tpu_torch.augment.device import (
        apply_dihedral,
        augment_batch_on_device,
    )
    from cultionet_tpu_torch.data.batch import Batch

    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.random((8, 12, 100, 100, 3), dtype=np.float32))
    y = torch.from_numpy(rng.integers(-1, 3, (8, 100, 100)).astype(np.int16))
    bdist = torch.from_numpy(rng.random((8, 100, 100), dtype=np.float32))
    codes = torch.arange(8)
    want = apply_dihedral(x, y, bdist, codes)
    got = apply_dihedral(x.cuda(), y.cuda(), bdist.cuda(), codes.cuda())
    for name, a, b in zip(("x", "y", "bdist"), got, want):
        require(torch.equal(a.cpu(), b), f"device_data dihedral: {name} differs")

    num = 4096
    grid = torch.arange(4, dtype=torch.float32, device="cuda").reshape(1, 1, 2, 2, 1)
    generator = torch.Generator(device="cuda").manual_seed(5)
    out = augment_batch_on_device(
        Batch(x=grid.expand(num, 1, 2, 2, 1).contiguous()), generator
    ).x.reshape(num, 4)
    patterns = apply_dihedral(grid.expand(8, 1, 2, 2, 1), None, None,
                              torch.arange(8, device="cuda"))[0].reshape(8, 4)
    drawn = (out[:, None, :] == patterns[None]).all(-1).float().argmax(1)
    require(bool((out == patterns[drawn]).all()), "device_data: unknown pattern")
    counts = torch.bincount(drawn, minlength=8).cpu().numpy()
    p_value = float(stats.chisquare(counts).pvalue)
    require(p_value > 1e-3, f"device_data codes {counts}: p {p_value}")
    sigma = 0.01
    noise = augment_batch_on_device(
        Batch(x=torch.zeros(num, 12, 10, 10, 3, device="cuda")), generator,
        dihedral=False, noise_sigma=sigma,
    ).x.double()
    mean, std, n = float(noise.mean()), float(noise.std()), noise.numel()
    require(
        abs(mean) < 3 * sigma / np.sqrt(n) and abs(std / sigma - 1) < 0.02,
        f"device_data noise: mean {mean}, std {std} over {n}",
    )
    return {"code_counts": counts.tolist(), "code_chi2_p": p_value,
            "noise_mean": mean, "noise_std": std, "noise_sigma": sigma}


class GradCapture:
    """Stands in for a train state's optimizer: keeps the gradients the
    step leaves in the parameters and clears them, so a step's gradients
    can be read without an update."""

    def __init__(self, model):
        self.model = model
        self.grads = None

    def step(self) -> None:
        self.grads = {
            n: p.grad.detach().clone() for n, p in self.model.named_parameters()
        }
        for p in self.model.parameters():
            p.grad = None


def data_step_parity(dataset, store: dict, norm) -> dict:
    """fp32 at dropout 0 (TF32 off, cuDNN deterministic) on 2 chips: the
    in-step step (norm_stats, dihedral off) on their raw int16 records
    against the host path's step on the same records scaled and normalized
    as ChipDataset does (loss within 1e-5 relative, gradients within
    train_parity's limits; the two dequantize formulas differ by an ulp in
    places); the hbm step against the in-step step on the gathered batch
    (loss and gradients equal bit for bit)."""
    import copy

    from cultionet_tpu_torch.data.batch import Batch
    from cultionet_tpu_torch.data.datasets import ChipDataset
    from cultionet_tpu_torch.data.device_cache import DeviceChipCache, gather_batch
    from cultionet_tpu_torch.nn.init import init_parameters_
    from cultionet_tpu_torch.train.optim import build_optimizer
    from cultionet_tpu_torch.train.step import (
        create_train_state,
        make_hbm_train_step,
        make_train_step,
    )

    chips = [17, 30]
    records = {k: v[chips] for k, v in store["want"].items()}
    host = norm(Batch(
        x=torch.from_numpy(ChipDataset._scale(records["x"], 1e-9, 1.0)),
        y=torch.from_numpy(records["y"].astype(np.int32)),
        bdist=torch.from_numpy(ChipDataset._scale(records["bdist"], 1e-9, 1.0)),
    ))
    stats_ = (norm.dataset_mean, norm.dataset_std)
    kwargs = dict(loss_name="TanimotoComplementLoss", device="cuda")
    model = cli_model(dropout=0.0)
    init_parameters_(model, torch.Generator().manual_seed(3))

    def run(step, *args):
        state = create_train_state(
            copy.deepcopy(model), build_optimizer("AdamW", 1e-3), device="cuda"
        )
        state.optimizer = GradCapture(state.model)
        _, logs = step(state, *args, torch.Generator(device="cuda").manual_seed(0))
        return float(logs["loss"]), state.optimizer.grads

    cache = DeviceChipCache(dataset, batch_size=4, device="cuda")
    idx = torch.tensor(chips, device="cuda")
    torch.backends.cudnn.deterministic = True
    try:
        in_step = run(
            make_train_step(norm_stats=stats_, **kwargs),
            gather_batch(cache.arrays, idx),
        )
        host_path = run(make_train_step(**kwargs), host)
        hbm = run(make_hbm_train_step(norm_stats=stats_, **kwargs), cache.arrays, idx)
    finally:
        torch.backends.cudnn.deterministic = False
    del cache
    rel = abs(in_step[0] - host_path[0]) / abs(host_path[0])
    require(rel <= 1e-5, f"device_data: in-step loss {in_step[0]} vs {host_path[0]}")
    record = {"in_step_vs_host_loss_rel": rel,
              **require_grads_close("device_data in-step", in_step[1], host_path[1])}
    require(
        hbm[0] == in_step[0]
        and all(torch.equal(hbm[1][n], g) for n, g in in_step[1].items()),
        "device_data: the hbm step differs from the in-step step",
    )
    record["hbm_vs_in_step"] = "equal"
    return record


PROFILE_STEPS = (4, 6)  # the train steps of the first epoch run under the profiler


@contextlib.contextmanager
def timed_train_loops():
    """While open, each epoch's train loop in ``fit`` is timed: from the
    train loader's first request (the card idle) to the card finishing
    the last step, host clock. In the first epoch, steps PROFILE_STEPS
    run under the profiler (from a synchronize to a synchronize), for
    their kernels' device time and the host time they took. The
    validation loader (a ChipLoader that does not shuffle) is not
    timed."""
    from torch.profiler import ProfilerActivity, profile

    from cultionet_tpu_torch.data.chipstore import ChipstoreLoader
    from cultionet_tpu_torch.data.device_cache import DeviceChipCache
    from cultionet_tpu_torch.data.loader import ChipLoader

    loops = {"seconds": []}
    originals = {
        cls: cls.__iter__ for cls in (ChipLoader, ChipstoreLoader, DeviceChipCache)
    }

    def timed(original):
        def __iter__(self):
            if isinstance(self, ChipLoader) and not self.shuffle:
                yield from original(self)
                return
            first = not loops["seconds"]
            torch.cuda.synchronize()
            start = time.perf_counter()
            for i, batch in enumerate(original(self)):
                if first and i in PROFILE_STEPS:
                    torch.cuda.synchronize()
                    if i == PROFILE_STEPS[0]:
                        prof = profile(activities=[ProfilerActivity.CUDA])
                        prof.__enter__()
                        profiled = time.perf_counter()
                    else:
                        loops["profiled_s"] = time.perf_counter() - profiled
                        prof.__exit__(None, None, None)
                        _, loops["device_us"], loops["top"] = device_time_by_kernel(
                            prof, 5
                        )
                yield batch
            torch.cuda.synchronize()
            loops["seconds"].append(time.perf_counter() - start)

        return __iter__

    for cls, original in originals.items():
        cls.__iter__ = timed(original)
    try:
        yield loops
    finally:
        for cls, original in originals.items():
            cls.__iter__ = original


def data_fit(label: str, root, workdir, norm, options: dict) -> dict:
    """2 epochs of ``fit`` at the CLI's training defaults with
    ``options``: its launches, each epoch's train loop seconds
    (``timed_train_loops``), train chips/s of the second, the device idle
    share of two profiled steps of the first, and the whole fit's
    seconds (the profile's processing included). A stream fit's store is
    built first, so the fit finds it."""
    from cultionet_tpu_torch.data import chipstore
    from cultionet_tpu_torch.model import fit

    ckpt = workdir / f"data_fit_{label}"
    if options.get("use_chipstore") == "stream":
        train_ds, _ = fit_params(root, ckpt, norm, 2).dataset.split_train_val(0.2)
        chipstore.build_chipstore_from_dataset(train_ds, ckpt / "train.cts")
    zero_launches()
    with timed_train_loops() as loops:
        start = time.perf_counter()
        result = fit(fit_params(root, ckpt, norm, 2, **options))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
    launches = read_launches()
    require(
        launches == fit_launches(2 * DATA_STEPS, 2 * DATA_VAL_BATCHES),
        f"device_data fit {label} launched {launches}",
    )
    for row in result.history:
        for key in ("loss", "val_loss", "val_score"):
            require(np.isfinite(row[key]), f"device_data fit {label}: {row}")
    require(
        len(loops["seconds"]) == 2 and "device_us" in loops,
        f"device_data fit {label}: {loops}",
    )
    steps = PROFILE_STEPS[1] - PROFILE_STEPS[0]
    return {
        "fit_2_epochs_s": seconds,
        "train_loop_s": loops["seconds"],
        "train_chips_per_s": 4 * DATA_STEPS / loops["seconds"][1],
        "profiled_step_ms": loops["profiled_s"] * 1e3 / steps,
        "profiled_step_device_ms": loops["device_us"] / 1e3 / steps,
        "profiled_device_idle_share": 1.0
        - loops["device_us"] / 1e6 / loops["profiled_s"],
        "profiled_top": loops["top"],
        "history": result.history,
        "launches": launches,
        "stores": sorted(p.name for p in ckpt.glob("*.cts")),
    }


def hbm_resume_check(root, workdir, norm) -> dict:
    """"hbm" with in-step augmentation at dropout 0.2: 1 epoch then a
    resume to 2 against an uninterrupted 2-epoch fit: the val_loss history
    and the parameters equal bit for bit (cuDNN deterministic; the
    learning rate decays exponentially, a schedule that does not depend on
    the number of epochs)."""
    from cultionet_tpu_torch.model import fit

    options = dict(
        use_chipstore="hbm", device_augment=True, device_augment_noise=0.01,
        lr_scheduler="ExponentialLR",
    )
    torch.backends.cudnn.deterministic = True
    try:
        fit(fit_params(root, workdir / "resume_a", norm, 1, **options))
        resumed = fit(fit_params(root, workdir / "resume_a", norm, 2, **options))
        whole = fit(fit_params(root, workdir / "resume_b", norm, 2, **options))
    finally:
        torch.backends.cudnn.deterministic = False
    history = [
        float(line.split(",")[2])
        for line in (workdir / "resume_a" / "history.csv").read_text().splitlines()[1:]
    ]
    require(
        history == [r["val_loss"] for r in whole.history]
        and [r["epoch"] for r in resumed.history] == [1],
        f"device_data resume: val_loss {history} vs "
        f"{[r['val_loss'] for r in whole.history]}",
    )
    got, want = resumed.state.model.state_dict(), whole.state.model.state_dict()
    for name, value in want.items():
        require(torch.equal(got[name], value), f"device_data resume: {name} differs")
    return {"val_loss": history}


def phase_device_data(smi: str, workdir) -> None:
    """The device data path (``--use-chipstore``, ``--device-augment``):
    see the module docstring, item 23."""
    import logging

    from cultionet_tpu_torch.data import chipstore
    from cultionet_tpu_torch.data.datasets import ChipDataset
    from cultionet_tpu_torch.model import fit
    from cultionet_tpu_torch.scripts.cli import main as cli
    from cultionet_tpu_torch.train.checkpoint import Checkpointer
    from cultionet_tpu_torch.utils.normalize import NormValues

    phase_start = time.perf_counter()
    start = time.perf_counter()
    chipstore.build_library()
    build_s = time.perf_counter() - start

    project = workdir / "data_project"
    regions = [f"d{k:02d}" for k in range(DATA_REGIONS)]
    rng = np.random.default_rng(41)
    for k, region in enumerate(regions):
        bounds = (700000.0 + 2000.0 * k, 4200000.0, 701000.0 + 2000.0 * k, 4201000.0)
        write_field_region(project / "time_series_vars" / region, rng, bounds)
    start = time.perf_counter()
    cli(["create", "-p", str(project), "--regions", *regions])
    create_s = time.perf_counter() - start
    root = project / "data" / "train"
    require(
        len(list((root / "processed").glob("*.npz"))) == DATA_REGIONS,
        "device_data: create wrote the wrong number of chips",
    )
    start = time.perf_counter()
    norm = NormValues.from_dataset(
        ChipDataset(root), {"max_crop_class": 1, "edge_class": 2}
    )
    norm_s = time.perf_counter() - start
    train_ds, _ = ChipDataset(root, norm_values=norm).split_train_val(0.2)
    require(len(train_ds) == 4 * DATA_STEPS, f"device_data: {len(train_ds)} train chips")

    store = data_store(train_ds, workdir / "data_store" / "train.cts")
    record = {
        "phase": "device_data",
        "card": smi,
        "chips": [DATA_REGIONS, 12, 100, 100, 3],
        "train_chips": len(train_ds),
        "precision": "16-mixed",
        "chipstore_build_s": build_s,
        "create_s": create_s,
        "norm_s": norm_s,
        "store_write_s": store["write_s"],
        "store_bytes": store["bytes"],
    }
    part_s = {"setup": time.perf_counter() - phase_start}

    def mark(name: str) -> None:
        part_s[name] = time.perf_counter() - phase_start - sum(part_s.values())

    record.update(stream_epochs(train_ds, store))
    record.update(resident_split(train_ds, store))
    mark("store_and_resident")
    record["device_augment"] = device_augment_checks()
    mark("device_augment")
    record["step_parity"] = data_step_parity(train_ds, store, norm)
    mark("step_parity")

    fits = {}
    for label, options in DATA_FITS:
        fits[label] = data_fit(label, root, workdir, norm, options)
        mark(f"fit_{label}")
        print(f"device_data fit {label}: {fits[label]['train_loop_s']} s train "
              f"loops", flush=True)
    require(
        len(fits["stream"]["stores"]) == 1 and not fits["hbm"]["stores"],
        f"device_data: stores {fits['stream']['stores']}, {fits['hbm']['stores']}",
    )
    record["fits"] = fits
    record["resume"] = hbm_resume_check(root, workdir, norm)
    mark("resume")
    # Where an epoch's host time goes: the loader alone and one save.
    record["loader_epoch_s"] = {
        label: loader_s(root, norm, prob, batches=DATA_STEPS)
        for label, prob in (("host_augment_0", 0.0), ("host_augment_0.5", 0.5))
    }
    record["loader_epoch_s"]["stream"] = record["stream_epoch_s_pinned_ring"][1]
    record["loader_epoch_s"]["hbm"] = record["resident_epoch_gather_s"]
    state = fit(fit_params(root, workdir / "data_skip", norm, 1, skip_train=True)).state
    start = time.perf_counter()
    Checkpointer(workdir / "data_timing").save_last(state, 0)
    torch.cuda.synchronize()
    record["checkpoint_save_s"] = time.perf_counter() - start
    del state

    # use_latlon cannot train from the resident split.
    zero_launches()
    try:
        fit(fit_params(root, workdir / "data_latlon", norm, 1,
                       use_chipstore="hbm", use_latlon=True))
        raise AssertionError("device_data: hbm with use_latlon did not raise")
    except ValueError as err:
        require("use_latlon" in str(err), f"device_data latlon: {err}")
    require(not any(read_launches().values()), "device_data: latlon launched")

    # The command line: auto picks the resident split and logs its size.
    messages = []

    class Collect(logging.Handler):
        def emit(self, log_record):
            messages.append(log_record.getMessage())

    fit_logger = logging.getLogger("cultionet_tpu_torch.train.fit")
    handler, level = Collect(), fit_logger.level
    fit_logger.addHandler(handler)
    fit_logger.setLevel(logging.INFO)
    zero_launches()
    start = time.perf_counter()
    try:
        cli(["train", "-p", str(project), "--epochs", "1", "--use-chipstore",
             "auto", "--device-augment"])
        torch.cuda.synchronize()
    finally:
        fit_logger.removeHandler(handler)
        fit_logger.setLevel(level)
    cli_s = time.perf_counter() - start
    launches = read_launches()
    resident = [m for m in messages if m.startswith("device-resident dataset")]
    require(
        launches == fit_launches(DATA_STEPS, DATA_VAL_BATCHES)
        and resident and "MB" in resident[0]
        and not list(project.rglob("*.cts")),
        f"device_data cli: launched {launches}, log {messages}",
    )
    record["cli"] = {"train_1_epoch_s": cli_s, "log": resident[0],
                     "launches": launches}
    mark("loader_save_latlon_cli")
    record["part_s"] = part_s
    record["seconds"] = time.perf_counter() - phase_start
    emit(record)


DP_BATCH = 8  # the global batch of the two-rank checks: 4 chips a rank
DP_TIMED_STEPS = 10


def dp_batch():
    from cultionet_tpu_torch.data.synthetic import create_batch

    return create_batch(
        num_channels=3, num_time=12, height=100, width=100,
        batch_size=DP_BATCH, rng=np.random.default_rng(3),
    )


def deterministic_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def dp_whole(tensor):
    """A DTensor (an FSDP2 ``Shard(0)`` shard, ``torch.chunk``'s blocks)
    gathered whole by one plain ``all_gather`` of equal padded blocks; any
    other tensor as it is. The two ranks of phase_data_parallel share the
    one card over gloo (NCCL refuses two ranks on one device), and
    DTensor's own ``full_tensor`` goes through functional collectives,
    which crash with gloo on CUDA tensors (torch 2.11). A group of one
    rank per card (NCCL) uses ``full_tensor``, as the port does."""
    from cultionet_tpu_torch.parallel.mesh import is_sharded

    if not is_sharded(tensor):
        return tensor
    import torch.distributed as dist

    world = dist.get_world_size()
    local = tensor.to_local()
    size = tensor.shape[0]
    padded = local.new_zeros((-(-size // world), *tensor.shape[1:]))
    padded[: local.shape[0]] = local
    parts = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(parts, padded)
    return torch.cat(parts)[:size]


def keep_gradients(state) -> dict:
    """Wrap ``state.optimizer.step`` so that its next call first copies
    every parameter's gradient, whole (a collective under FSDP2), to the
    host into the returned dict: the gradient the optimizer sees, after the
    all-reduce and before the clip. Adam's update and the clip hide a
    factor common to every gradient; this does not."""
    grads = {}
    update = state.optimizer.step

    def step_keeping_gradients():
        grads.update(
            {
                n: dp_whole(p.grad.detach()).cpu()
                for n, p in state.model.named_parameters()
                if p.grad is not None
            }
        )
        return update()

    state.optimizer.step = step_keeping_gradients
    return grads


def dp_step_result(state, logs, grads) -> dict:
    return {
        "loss": float(logs["loss"]),
        "state": {
            n: dp_whole(t).detach().cpu()
            for n, t in state.model.state_dict().items()
        },
        "grads": grads,
    }


def dp_rank_main(rank: int, port: int, out_dir: str) -> None:
    """Rank ``rank`` of phase_data_parallel's two: both on the one card,
    joined over gloo."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank
    )
    try:
        dp_rank(torch.device("cuda", 0), out_dir)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def dp_rank(device, out_dir: str) -> None:
    """One of the two ranks of phase_data_parallel (gloo, both on the
    card): the dropout-0 fp32 sharded step, the same under FSDP2, then the
    CLI-default step timed."""
    from cultionet_tpu_torch.parallel import (
        make_sharded_train_step,
        rank_and_world,
        shard_batch,
        shard_state_fsdp,
    )
    from cultionet_tpu_torch.parallel.mesh import reduce_gradients
    from cultionet_tpu_torch.train.step import create_train_state

    import faulthandler

    faulthandler.enable()
    deterministic_fp32()
    rank, _ = rank_and_world()
    local = shard_batch(dp_batch()).to(device)
    result = {"rank": rank}

    model, tx = train_setup(0.0)
    state = create_train_state(model, tx, seed=0, device=device)
    step = make_sharded_train_step(precision="fp32", device=device)
    grads = keep_gradients(state)
    zero_launches()
    state, logs = step(state, local, torch.Generator(device).manual_seed(0))
    result["dp_launches"] = read_launches()
    result["dp"] = dp_step_result(state, logs, grads)

    model, tx = train_setup(0.0)
    state = create_train_state(model, tx, seed=0, device=device)
    try:
        result["fsdp_modules"] = shard_state_fsdp(state)
        state.optimizer = tx.init(state.model.parameters())
        grads = keep_gradients(state)
        state, logs = step(state, local, torch.Generator(device).manual_seed(0))
        result["fsdp"] = dp_step_result(state, logs, grads)
    except Exception as exc:  # reported by the phase, which then fails
        result["fsdp_error"] = f"{type(exc).__name__}: {exc}"
    del state

    model, tx = train_setup(0.2)
    state = create_train_state(model, tx, seed=0, device=device)
    step = make_sharded_train_step(precision="16-mixed", device=device)
    generator = torch.Generator(device).manual_seed(rank)
    for _ in range(TRAIN_WARMUP):
        step(state, local, generator)
    zero_launches()
    losses = []
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(DP_TIMED_STEPS):
        state, logs = step(state, local, generator)
        losses.append(logs["loss"])
    torch.cuda.synchronize()
    result["step_ms"] = (time.perf_counter() - start) / DP_TIMED_STEPS * 1e3
    result["launches"] = read_launches()
    result["losses"] = [float(v) for v in losses]
    for p in state.model.parameters():
        p.grad = torch.zeros_like(p)
    reduce_gradients(state.model)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(DP_TIMED_STEPS):
        reduce_gradients(state.model)
    torch.cuda.synchronize()
    result["allreduce_ms"] = (
        (time.perf_counter() - start) / DP_TIMED_STEPS * 1e3
    )
    result["grad_bytes"] = sum(
        p.numel() * 4 for p in state.model.parameters()
    )
    torch.save(result, Path(out_dir) / f"rank{rank}.pt")


def require_state_close(label: str, got: dict, want: dict, atol: float):
    worst = 0.0
    for name, value in want.items():
        if not value.is_floating_point():
            continue
        diff = float((got[name].float() - value.float()).abs().max())
        worst = max(worst, diff)
        require(diff <= atol, f"{label}: {name} differs by {diff} > {atol}")
    return worst


def phase_data_parallel(smi: str, workdir) -> None:
    """Item 24 of the module docstring: the data-parallel path on one
    card."""
    import copy

    import torch.distributed as dist

    from cultionet_tpu_torch.model import fit
    from cultionet_tpu_torch.parallel.distributed import free_port
    from cultionet_tpu_torch.parallel.mesh import is_sharded
    from cultionet_tpu_torch.parallel import (
        make_sharded_train_step,
        shard_state_fsdp,
    )
    from cultionet_tpu_torch.predict import ScenePredictor
    from cultionet_tpu_torch.train.step import (
        create_train_state,
        make_train_step,
    )

    phase_start = time.perf_counter()
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    deterministic_fp32()
    record = {"phase": "data_parallel", "smi": smi}

    # (b) two ranks on the one card over gloo, and FSDP2 on them.
    out = Path(workdir) / "dp_ranks"
    out.mkdir(parents=True, exist_ok=True)
    start = time.perf_counter()
    torch.multiprocessing.start_processes(
        dp_rank_main, args=(free_port(), str(out)), nprocs=2, join=True,
        start_method="spawn",
    )
    record["ranks_s"] = time.perf_counter() - start
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in (0, 1)]
    model, tx = train_setup(0.0)
    state = create_train_state(model, tx, seed=0, device="cuda")
    grads = keep_gradients(state)
    single_state, logs = make_train_step(precision="fp32", device="cuda")(
        state, dp_batch(), torch.Generator("cuda").manual_seed(0)
    )
    single = dp_step_result(single_state, logs, grads)
    del state, single_state
    want_na = {name: 0 for name in read_launches()}
    want_na["na2d_fwd"] = want_na["na2d_bwd"] = 3
    want_drop = {name: 0 for name in read_launches()}
    want_drop["na2d_fwd_drop"] = want_drop["na2d_bwd_drop"] = 3 * DP_TIMED_STEPS
    for got in ranks:
        r = got["rank"]
        require(
            abs(got["dp"]["loss"] - single["loss"]) <= 1e-5 * abs(single["loss"]),
            f"data_parallel: rank {r} loss {got['dp']['loss']} != {single['loss']}",
        )
        record[f"rank{r}_dp_max_abs_err"] = require_state_close(
            f"data_parallel rank {r}", got["dp"]["state"], single["state"], 1e-5
        )
        record[f"rank{r}_dp_grads"] = require_grads_close(
            f"data_parallel rank {r}", got["dp"]["grads"], single["grads"]
        )
        require(got["dp_launches"] == want_na,
                f"data_parallel: rank {r} step launches {got['dp_launches']}")
        if "fsdp_error" in got:
            print(f"data_parallel: FSDP2 refused two gloo ranks on one card: "
                  f"{got['fsdp_error']}", flush=True)
            require(False, "FSDP2 on two ranks failed")
        require(got["fsdp_modules"], "data_parallel: FSDP2 sharded nothing")
        require(
            abs(got["fsdp"]["loss"] - single["loss"]) <= 1e-5 * abs(single["loss"]),
            f"data_parallel: rank {r} FSDP loss {got['fsdp']['loss']}",
        )
        record[f"rank{r}_fsdp_max_abs_err"] = require_state_close(
            f"data_parallel FSDP rank {r}", got["fsdp"]["state"],
            single["state"], 1e-5,
        )
        record[f"rank{r}_fsdp_grads"] = require_grads_close(
            f"data_parallel FSDP rank {r}", got["fsdp"]["grads"],
            single["grads"],
        )
        require(got["launches"] == want_drop,
                f"data_parallel: rank {r} timed launches {got['launches']}")
        require(all(np.isfinite(got["losses"])), "data_parallel: a loss is not finite")
        record[f"rank{r}_step_ms"] = got["step_ms"]
        record[f"rank{r}_allreduce_ms"] = got["allreduce_ms"]
        record[f"rank{r}_allreduce_share"] = got["allreduce_ms"] / got["step_ms"]
        record[f"rank{r}_launches_per_step"] = {
            k: v // DP_TIMED_STEPS for k, v in got["launches"].items() if v
        }
    record["fsdp_modules"] = len(ranks[0]["fsdp_modules"])
    record["grad_bytes"] = ranks[0]["grad_bytes"]

    # (a) fit through the sharded step in an NCCL group of one.
    root = Path(workdir) / "dp_fit"
    write_fit_chips(root)

    def fp32_params(ckpt):
        params = fit_params(root, ckpt, None, 1)
        params.precision = "32"
        return params

    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
        rank=0,
    )
    try:
        zero_launches()
        grouped = fit(fp32_params(root / "grouped"), device="cuda")
        record["fit_launches"] = read_launches()
        require(record["fit_launches"] == fit_launches(4, 1),
                f"data_parallel: fit launches {record['fit_launches']}")

        # (c) FSDP2 at world size 1.
        model, tx = train_setup(0.0)
        state = create_train_state(model, tx, seed=0, device="cuda")
        plain_state = copy.deepcopy(state)
        plain_state.optimizer = tx.init(plain_state.model.parameters())
        names = shard_state_fsdp(state)
        require(names and any(is_sharded(p) for p in state.model.parameters()),
                "data_parallel: FSDP2 at world size 1 sharded nothing")
        state.optimizer = tx.init(state.model.parameters())
        batch = train_batch()
        grads = keep_gradients(state)
        sharded_state, logs = make_sharded_train_step(
            precision="fp32", device="cuda"
        )(state, batch, torch.Generator("cuda").manual_seed(0))
        got = dp_step_result(sharded_state, logs, grads)
        grads = keep_gradients(plain_state)
        plain_state, logs = make_train_step(precision="fp32", device="cuda")(
            plain_state, batch, torch.Generator("cuda").manual_seed(0)
        )
        want = dp_step_result(plain_state, logs, grads)
        record["fsdp1_max_abs_err"] = require_state_close(
            "data_parallel FSDP world 1", got["state"], want["state"], 1e-6
        )
        record["fsdp1_grads"] = require_grads_close(
            "data_parallel FSDP world 1", got["grads"], want["grads"]
        )
        record["fsdp1_loss_diff"] = abs(got["loss"] - want["loss"])
        require(record["fsdp1_loss_diff"] <= 1e-6 * abs(want["loss"]),
                "data_parallel: FSDP world-1 loss differs")
        del state, sharded_state, plain_state
    finally:
        dist.destroy_process_group()
    plain = fit(fp32_params(root / "plain"), device="cuda")
    require(grouped.history == plain.history,
            f"data_parallel: fit history {grouped.history} != {plain.history}")
    require_states_equal(grouped.state, plain.state)
    record["fit_loss"] = grouped.history[0]["loss"]

    # (d) predict through the multi-device split, one replica.
    model = plain.model
    scene = np.random.default_rng(11).integers(
        0, 10000, (12, 420, 420, 3)
    ).astype(np.int16)
    today = ScenePredictor(model, batch_size=8, precision="fp32", device="cuda")
    want_raster, _ = today.predict_scene(scene, window_size=100, padding=20)
    split = ScenePredictor(
        model, batch_size=8, precision="fp32", device="cuda", devices=1
    )
    split.predict_step = split._predict_split
    zero_launches()
    got_raster, _ = split.predict_scene(scene, window_size=100, padding=20)
    record["predict_launches"] = read_launches()
    require(record["predict_launches"]["na2d_fwd"] == 12,
            f"data_parallel: predict launches {record['predict_launches']}")
    require(np.array_equal(got_raster, want_raster),
            "data_parallel: the split predict differs from today's")
    record["predict_refusal"] = None
    try:
        ScenePredictor(model, device="cuda", devices=torch.cuda.device_count() + 1)
    except RuntimeError as exc:
        record["predict_refusal"] = str(exc)
    require(record["predict_refusal"] is not None,
            "data_parallel: predict on more cards than present ran")

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    record["seconds"] = time.perf_counter() - phase_start
    emit(record)


IMPORT_HYPER = dict(  # the CLI defaults, as a Lightning checkpoint holds them
    in_channels=3, in_time=12, hidden_channels=64, dropout=0.2,
    activation_type="SiLU", dilations=[1, 2], res_block_type="resa",
    attention_weights="natten", pool_by_max=False, batchnorm_first=False,
)


def reference_source_model():
    """The CLI-default model with weights from a seeded generator and
    BatchNorm running means ~ 0.1 N(0, 1) and variances in [1, 2], as the
    parity tests draw them; eval mode, on the host."""
    from cultionet_tpu_torch.nn.init import init_parameters_

    gen = torch.Generator().manual_seed(11)
    model = cli_model()
    init_parameters_(model, gen)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, torch.nn.modules.batchnorm._BatchNorm):
                shape = module.running_mean.shape
                module.running_mean.copy_(0.1 * torch.randn(shape, generator=gen))
                module.running_var.copy_(1.0 + torch.rand(shape, generator=gen))
    return model.eval()


def start_import_torch(project, ckpt_path) -> subprocess.Popen:
    """``python -m cultionet_tpu_torch import-torch`` in a subprocess (on
    the card, the command's default)."""
    return subprocess.Popen(
        [sys.executable, "-m", "cultionet_tpu_torch", "import-torch", "-p",
         str(project), "--torch-ckpt", str(ckpt_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=Path(__file__).resolve().parent,
    )


def phase_import_torch(smi: str, workdir) -> None:
    """A reference Lightning checkpoint of the CLI-default model through
    ``import-torch``, its store predicting as the source model does."""
    import re

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from torch_reference_keys import lightning_checkpoint

    from cultionet_tpu_torch.model import load_model
    from cultionet_tpu_torch.predict import ScenePredictor

    deterministic_fp32()
    phase_start = time.perf_counter()
    source = reference_source_model()
    ckpt = lightning_checkpoint(source.state_dict(), IMPORT_HYPER)
    root = workdir / "import_torch"
    root.mkdir()
    torch.save(ckpt, root / "last.ckpt")
    # The refusal runs beside the import (each process takes seconds to
    # reach the card); the import's seconds are its own process's, start
    # to exit.
    bad_key = "cultionet_model.mask_model.final_combine.final_dist.0.weight"
    bad = {"state_dict": dict(ckpt["state_dict"]),
           "hyper_parameters": ckpt["hyper_parameters"]}
    bad["state_dict"][bad_key] = bad["state_dict"][bad_key].repeat(1, 2, 1, 1)
    torch.save(bad, root / "bad.ckpt")
    start = time.perf_counter()
    procs = [start_import_torch(root / "project", root / "last.ckpt"),
             start_import_torch(root / "bad_project", root / "bad.ckpt")]
    try:
        out, err = procs[0].communicate(timeout=600)
        import_s = time.perf_counter() - start
        bad_out, bad_err = procs[1].communicate(timeout=600)
        refused_s = time.perf_counter() - start
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    log = out + err
    require(procs[0].returncode == 0,
            f"import-torch exited {procs[0].returncode}: {log[-3000:]}")
    found = re.search(r"Imported (\d+) torch entries", log)
    require(found is not None, f"import-torch logged no count: {log[-2000:]}")
    entries = int(found.group(1))
    require(entries == len(ckpt["state_dict"]), f"imported {entries} entries")
    print(f"import-torch: {entries} entries imported in {import_s} s on {smi}", flush=True)
    refused_log = bad_out + bad_err
    require(
        procs[1].returncode != 0
        and "mask_model/final_combine/final_dist/kernel" in refused_log,
        f"import-torch of a bad checkpoint: exit {procs[1].returncode} "
        f"{refused_log[-2000:]}",
    )

    _, imported = load_model(root / "project" / "ckpt" / "last_store", device="cuda")
    source = source.to("cuda")
    scene = (
        np.random.default_rng(0).random((12, 420, 420, 3)) * 10000.0
    ).astype("int16")
    batches = 4  # 25 windows of 140^2 in batches of 8
    results = {}
    for precision in ("fp32", "bf16"):
        rasters = {}
        for name, model in (("source", source), ("imported", imported)):
            predictor = ScenePredictor(model, batch_size=8, precision=precision)
            zero_launches()
            start = time.perf_counter()
            rasters[name], size = predictor.predict_scene(
                scene, window_size=100, padding=20
            )
            seconds = time.perf_counter() - start
            launches = read_launches()
            want = {k: 0 for k in launches} | {"na2d_fwd": 3 * batches}
            require(launches == want, f"import_torch {name} {precision} launched {launches}")
            require(size == (420, 420), f"import_torch scene size {size}")
        got, want = rasters["imported"], rasters["source"]
        require(got.shape == (420, 420, 3) and bool(np.isfinite(got).all()),
                f"import_torch {precision} raster {got.shape}")
        lo, hi = float(got.min()), float(got.max())
        require(0.0 <= lo and hi <= 1.0, f"import_torch raster in [{lo}, {hi}]")
        require(
            np.array_equal(got, want),
            f"import_torch {precision}: imported vs source max-abs "
            f"{float(np.abs(got - want).max())}",
        )
        results[precision] = {
            "predict_s": seconds, "launches": launches, "raster_min": lo,
            "raster_max": hi,
        }
    emit(
        {
            "phase": "import_torch",
            "nvidia_smi": smi,
            "entries": entries,
            "import_s": import_s,
            "refused_s": refused_s,
            "refused_entry": bad_key,
            "scene": [12, 420, 420, 3],
            "batches": batches,
            "bit_for_bit": True,
            "imported": results,
            "seconds": time.perf_counter() - phase_start,
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
        "library_ms": summary.get("library_ms"),
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
    temporal_fwd = phase_temporal_fwd()
    temporal_bwd = phase_temporal_bwd()
    layer_norm = phase_layer_norm()
    na_block = phase_na_block_fwd()
    na_block_launches = phase_na_block_grad()

    model = build_model()
    phase_model(model)
    predict_launches = phase_predict(model)
    phase_profile(model)
    del model
    model = build_model("transformer")
    phase_model(model, "transformer")
    predict_t_launches = phase_predict(model, "transformer")
    phase_profile(model, "transformer")
    del model
    torch.cuda.empty_cache()

    state, batch, train_launches, steps_per_s = phase_train(smi)
    conv_steps_per_s = steps_per_s
    parity_launches = phase_train_parity()
    phase_eval(state, batch)
    phase_train_profile(state, batch, steps_per_s)
    del state
    torch.cuda.empty_cache()
    state, batch, train_t_launches, steps_per_s = phase_train(
        smi, "transformer"
    )
    phase_train_parity("transformer")
    phase_train_profile(state, batch, steps_per_s, "transformer")
    del state
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        fit_result = phase_fit(conv_steps_per_s, Path(tmp))
        phase_fit_augment(fit_result)
        phase_predict_raster(fit_result)
        phase_export(fit_result, Path(tmp))
        phase_transfer(fit_result, Path(tmp))
        phase_cli(Path(tmp))
        phase_model_options(smi, Path(tmp))
        phase_device_data(smi, Path(tmp))
        phase_data_parallel(smi, Path(tmp))
        phase_import_torch(smi, Path(tmp))

    fwd_src = "cultionet_tpu_torch/ops/csrc/na2d_fwd.cu"
    bwd_src = "cultionet_tpu_torch/ops/csrc/na2d_bwd.cu"
    pallas = "cultionet_tpu/ops/natten_pallas.py"
    temporal_pallas = "cultionet_tpu/ops/temporal_pallas.py"
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
                kernel_entry(
                    "temporal_fwd",
                    "cultionet_tpu_torch/ops/csrc/temporal_fwd.cu",
                    f"{temporal_pallas}:131",
                    predict_t_launches["temporal_fwd"], temporal_fwd,
                ),
                kernel_entry(
                    "temporal_bwd",
                    "cultionet_tpu_torch/ops/csrc/temporal_bwd.cu",
                    f"{temporal_pallas}:150",
                    train_t_launches["temporal_bwd"], temporal_bwd,
                ),
                kernel_entry(
                    "layer_norm_rows",
                    "cultionet_tpu_torch/ops/csrc/layer_norm_fwd.cu",
                    "none (XLA fuses LayerNorm on the TPU)",
                    predict_t_launches["layer_norm_rows"], layer_norm,
                ),
                kernel_entry(
                    "na_block_fwd",
                    "cultionet_tpu_torch/ops/csrc/na_block_fwd.cu",
                    f"{pallas}:1030",
                    na_block_launches["na_block_fwd"], na_block,
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
