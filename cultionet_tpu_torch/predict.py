"""Large-scene sliding-window inference with on-device blending (port of
cultionet_tpu/predict.py, the per-batch path of ``predict_scene``).

Each window carries a taper weight map (1 in the interior, a raised-cosine
ramp over the overlap); windows accumulate into scene-level weighted sums on
the device, and the raster is the weight-normalized sum.

Not yet ported: the JAX whole-scene ``lax.scan`` (a TPU dispatch tactic),
``predict_windows`` / ``predict_to_raster`` over chip files, GeoTIFF
output, lat/lon centroids and multi-device predict.
"""

import math
import typing as T

import numpy as np
import torch
from torch import nn

from .data.create import (
    _slice_window,
    iter_window_jobs,
    prepare_image_time_series,
)
from .enums import InferenceNames
from .train.step import make_predict_step
from .utils.device import resolve_device

Tensor = torch.Tensor

BAND_NAMES = (
    InferenceNames.DISTANCE,
    InferenceNames.EDGE,
    InferenceNames.CROP,
)


def taper_weights(
    window_size: int,
    padding: int,
    dtype: torch.dtype = torch.float32,
    device="cpu",
) -> Tensor:
    """(S, S) blending weights, S = window_size + 2*padding: 1 in the
    interior, raised-cosine ramp to ~0 across the padded overlap."""
    size = window_size + 2 * padding
    if padding == 0:
        return torch.ones((size, size), dtype=dtype, device=device)
    steps = torch.arange(1, padding + 1, dtype=torch.float32, device=device)
    ramp = 0.5 - 0.5 * torch.cos(math.pi * (steps / (padding + 1)))
    profile = torch.cat(
        [ramp, torch.ones(window_size, device=device), ramp.flip(0)]
    )
    weights = torch.outer(profile, profile).to(dtype)
    return torch.clamp(weights, min=1e-4)


def accumulate_windows(
    scene_sum: Tensor,  # (H, W, 3)
    scene_weight: Tensor,  # (H, W, 1)
    window_preds: Tensor,  # (B, S, S, 3)
    weights: Tensor,  # (S, S)
    row0s: T.Sequence[int],
    col0s: T.Sequence[int],
) -> None:
    """Blend a batch of windows into the buffers in place, one window after
    another, so overlapping windows of one batch accumulate correctly."""
    size = weights.shape[0]
    w = weights[..., None]
    for pred, r, c in zip(window_preds, row0s, col0s):
        scene_sum[r : r + size, c : c + size] += pred * w
        scene_weight[r : r + size, c : c + size] += w


class ScenePredictor:
    """Predict a full scene from overlapping windows.

    ``model`` is a ``CultioNet`` with its weights; the predictor runs an eval
    copy of it on ``device`` in the compute precision (bf16 on the card by
    default; fp32 when asked, and always on the CPU, as the JAX predictor
    runs fp32 off the TPU).
    """

    def __init__(
        self,
        model: nn.Module,
        batch_size: int = 8,
        precision: str = "bf16",
        device="cuda",
    ):
        self.device = resolve_device(device)
        if self.device.type != "cuda":
            precision = "fp32"
        self.precision = precision
        self.batch_size = batch_size
        self.predict_step = make_predict_step(model, precision, self.device)

    def predict_scene(
        self,
        image_time_series: np.ndarray,  # (T, H, W, C)
        window_size: int = 100,
        padding: int = 20,
        gain: float = 1e-4,
        offset: float = 0.0,
    ) -> T.Tuple[np.ndarray, T.Tuple[int, int]]:
        """In-memory large-scene inference; returns the stitched (H, W, 3)
        float32 raster in [0, 1] (distance, edge, crop) and (H, W).

        An int16 x 10000 scene (gain 1e-4, offset 0) rides to the device
        packed and dequantizes in the step; any other scene is scaled,
        NaN-masked and clipped to [1e-9, 1] on the host first.
        """
        x = np.asarray(image_time_series)
        packed = (
            np.issubdtype(x.dtype, np.integer)
            and gain == 1e-4
            and offset == 0.0
        )
        if packed:
            x = x.astype(np.int16, copy=False)
        else:
            x = prepare_image_time_series(x, gain=gain, offset=offset)
            # The chip-file path clips loaded chips to [1e-9, 1].
            x = np.clip(x, 1e-9, 1.0)
        _, scene_h, scene_w, _ = x.shape
        size = window_size + 2 * padding
        jobs = list(iter_window_jobs(scene_h, scene_w, window_size, padding))

        def batches():
            for i in range(0, len(jobs), self.batch_size):
                chunk = jobs[i : i + self.batch_size]
                windows = []
                for job in chunk:
                    w = _slice_window(x, job)
                    pad_b = size - w.shape[1]
                    pad_r = size - w.shape[2]
                    if pad_b > 0 or pad_r > 0:
                        w = np.pad(
                            w, ((0, 0), (0, pad_b), (0, pad_r), (0, 0))
                        )
                    windows.append(w)
                yield (
                    np.stack(windows),
                    [j["row_off"] for j in chunk],
                    [j["col_off"] for j in chunk],
                )

        return self._blend_windows(
            batches(), scene_h, scene_w, window_size, padding
        )

    def _blend_windows(
        self,
        batches: T.Iterable[T.Tuple[np.ndarray, T.List[int], T.List[int]]],
        scene_h: int,
        scene_w: int,
        window_size: int,
        padding: int,
    ) -> T.Tuple[np.ndarray, T.Tuple[int, int]]:
        pad = padding
        size = window_size + 2 * pad
        weights = taper_weights(window_size, pad, device=self.device)

        # Buffer coords = scene coords + pad, so the padded window starting
        # at scene row (row_off - pad) lands at buffer row row_off >= 0.
        buf_h = scene_h + 2 * pad + size
        buf_w = scene_w + 2 * pad + size
        scene_sum = torch.zeros((buf_h, buf_w, 3), device=self.device)
        scene_weight = torch.full((buf_h, buf_w, 1), 1e-8, device=self.device)

        for windows, row0s, col0s in batches:
            outputs = self.predict_step(torch.from_numpy(windows))
            preds = torch.cat(
                [outputs[name] for name in BAND_NAMES], dim=-1
            )  # (B, S, S, 3)
            accumulate_windows(
                scene_sum, scene_weight, preds, weights, row0s, col0s
            )

        blended = scene_sum / scene_weight
        # Scene pixel (r, c) lives at buffer (r + pad, c + pad).
        result = blended[pad : pad + scene_h, pad : pad + scene_w]
        return result.cpu().numpy(), (scene_h, scene_w)
