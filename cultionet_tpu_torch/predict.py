"""Large-scene sliding-window inference with on-device blending (port of
cultionet_tpu/predict.py: the per-batch path of ``predict_scene``,
``predict_windows`` and ``predict_to_raster``).

Each window carries a taper weight map (1 in the interior, a raised-cosine
ramp over the overlap); windows accumulate into scene-level weighted sums on
the device, and the raster is the weight-normalized sum. The windows come
from an in-memory scene (``predict_scene``) or from the window chips of
``data/create.py::create_predict_dataset`` (``predict_windows``);
``predict_to_raster`` writes the result as a 3-band uint16 GeoTIFF.
Every window goes to the model with the lat/lon centroid of its scene's
bounds, which a ``use_latlon`` model embeds: the bounds the window chips
carry, or those given to ``predict_scene`` (``(0, 0, 1, 1)`` when none
are, as in the JAX package).

``devices=N`` predicts on N cards from one process: a model replica per
card, each window batch (rounded up to a multiple of N, the last window
repeated into the extra slots, which are dropped before the blend) split
into N contiguous blocks that the replicas run at the same time; the
outputs are blended on the first card. No process group is needed.

Not ported: the JAX whole-scene ``lax.scan`` (a TPU dispatch tactic).
"""

import math
import typing as T
from pathlib import Path

import numpy as np
import torch
from torch import nn

from .data.batch import Batch
from .data.constant import SCALE_FACTOR
from .data.create import (
    _slice_window,
    iter_window_jobs,
    prepare_image_time_series,
)
from .data.datasets import ChipDataset
from .data.loader import ChipLoader
from .enums import InferenceNames
from .train.step import make_predict_step
from .utils.device import resolve_device
from .utils.profiling import span, to_host

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
    runs fp32 off the TPU). With ``devices=N`` on the card it runs a copy
    on each of ``cuda:0..N-1`` (and raises when the machine has fewer);
    on the CPU the N copies share it.
    """

    def __init__(
        self,
        model: nn.Module,
        batch_size: int = 8,
        precision: str = "bf16",
        device="cuda",
        devices: int = 1,
    ):
        self.device = resolve_device(device)
        if self.device.type != "cuda":
            precision = "fp32"
        targets = [self.device]
        if devices > 1:
            if batch_size % devices:
                # Every replica takes an equal block of each batch.
                batch_size += devices - batch_size % devices
            if self.device.type == "cuda":
                cards = torch.cuda.device_count()
                if cards < devices:
                    raise RuntimeError(
                        f"predict on {devices} devices needs {devices} "
                        f"cards; this machine has {cards}"
                    )
                targets = [torch.device("cuda", i) for i in range(devices)]
                self.device = targets[0]
            else:
                targets = [self.device] * devices
        self.precision = precision
        self.batch_size = batch_size
        self.devices = devices
        self._steps = [make_predict_step(model, precision, d) for d in targets]
        self.predict_step = (
            self._steps[0] if devices == 1 else self._predict_split
        )
        self._scene_bounds: T.Optional[T.Tuple[float, ...]] = None

    def _predict_split(
        self, windows, lat=None, lon=None
    ) -> T.Dict[str, T.Optional[Tensor]]:
        """One batch over the replicas: padded to a multiple of their count
        by repeating the last window, split into contiguous blocks, run,
        and the real windows' outputs gathered on the first device."""
        parts = [torch.as_tensor(v) if v is not None else None
                 for v in (windows, lat, lon)]
        n = parts[0].shape[0]
        extra = -n % self.devices

        def padded(value):
            if value is None or extra == 0:
                return value
            return torch.cat([value, value[-1:].expand(extra, *value.shape[1:])])

        blocks = [
            None if v is None else padded(v).chunk(self.devices)
            for v in parts
        ]
        outputs = [
            step(*(None if b is None else b[i] for b in blocks))
            for i, step in enumerate(self._steps)
        ]
        return {
            name: None
            if outputs[0][name] is None
            else torch.cat([o[name].to(self.device) for o in outputs])[:n]
            for name in outputs[0]
        }

    def predict_windows(
        self, dataset: ChipDataset
    ) -> T.Tuple[np.ndarray, T.Tuple[int, int]]:
        """Predict every window chip of ``dataset`` and blend them on the
        device; returns the stitched (H, W, 3) float32 raster in [0, 1]
        and (H, W).

        The scene's extent, the window size and the scene bounds come from
        the chips' headers (``Batch.read_meta``: the x arrays are not
        decompressed); the batches come from a ``ChipLoader`` in file
        order that delivers them to the predictor's device.
        """
        scene_h = scene_w = window_size = 0
        self._scene_bounds = None
        for path in dataset.files:
            meta = Batch.read_meta(path)
            height = int(meta.window_height[0])
            window_size = max(window_size, height)
            scene_h = max(scene_h, int(meta.window_row_off[0]) + height)
            scene_w = max(
                scene_w,
                int(meta.window_col_off[0]) + int(meta.window_width[0]),
            )
            if self._scene_bounds is None and meta.left is not None:
                self._scene_bounds = tuple(
                    float(getattr(meta, side)[0])
                    for side in ("left", "bottom", "right", "top")
                )
        chip_size = dataset.load_file(dataset.files[0]).x.shape[2]
        padding = (chip_size - window_size) // 2

        loader = ChipLoader(
            dataset, batch_size=self.batch_size, shuffle=False,
            device=self.device,
        )
        batches = (
            (
                batch.x,
                batch.lat,
                batch.lon,
                batch.window_row_off.tolist(),
                batch.window_col_off.tolist(),
            )
            for batch in loader
        )
        return self._blend_windows(
            batches, scene_h, scene_w, window_size, padding
        )

    def predict_scene(
        self,
        image_time_series: np.ndarray,  # (T, H, W, C)
        window_size: int = 100,
        padding: int = 20,
        gain: float = 1e-4,
        offset: float = 0.0,
        bounds: T.Optional[T.Tuple[float, float, float, float]] = None,
    ) -> T.Tuple[np.ndarray, T.Tuple[int, int]]:
        """In-memory large-scene inference; returns the stitched (H, W, 3)
        float32 raster in [0, 1] (distance, edge, crop) and (H, W).

        An int16 x 10000 scene (gain 1e-4, offset 0) rides to the device
        packed and dequantizes in the step; any other scene is scaled,
        NaN-masked and clipped to [1e-9, 1] on the host first. Every
        window gets the centroid of the scene's ``bounds`` (left, bottom,
        right, top), or of ``(0, 0, 1, 1)`` without them, as the JAX
        predictor gives it.
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
        left, bottom, right, top = (
            bounds if bounds is not None else (0.0, 0.0, 1.0, 1.0)
        )
        lat = np.float32((bottom + top) / 2.0)
        lon = np.float32((left + right) / 2.0)
        self._scene_bounds = bounds

        def batches():
            for i in range(0, len(jobs), self.batch_size):
                chunk = jobs[i : i + self.batch_size]
                with span("predict.cut"):
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
                    windows = np.stack(windows)
                yield (
                    windows,
                    np.full(len(chunk), lat),
                    np.full(len(chunk), lon),
                    [j["row_off"] for j in chunk],
                    [j["col_off"] for j in chunk],
                )

        return self._blend_windows(
            batches(), scene_h, scene_w, window_size, padding
        )

    def _blend_windows(
        self,
        batches: T.Iterable[
            T.Tuple[T.Any, T.Any, T.Any, T.List[int], T.List[int]]
        ],
        scene_h: int,
        scene_w: int,
        window_size: int,
        padding: int,
    ) -> T.Tuple[np.ndarray, T.Tuple[int, int]]:
        with span("predict.scene"):
            pad = padding
            size = window_size + 2 * pad
            weights = taper_weights(window_size, pad, device=self.device)

            # Buffer coords = scene coords + pad, so the padded window
            # starting at scene row (row_off - pad) lands at buffer row
            # row_off >= 0.
            buf_h = scene_h + 2 * pad + size
            buf_w = scene_w + 2 * pad + size
            scene_sum = torch.zeros((buf_h, buf_w, 3), device=self.device)
            scene_weight = torch.full(
                (buf_h, buf_w, 1), 1e-8, device=self.device
            )

            for windows, lat, lon, row0s, col0s in batches:
                outputs = self.predict_step(windows, lat, lon)
                with span("predict.blend"):
                    preds = torch.cat(
                        [outputs[name] for name in BAND_NAMES], dim=-1
                    )  # (B, S, S, 3)
                    accumulate_windows(
                        scene_sum, scene_weight, preds, weights, row0s, col0s
                    )

            with span("predict.readback"):
                blended = scene_sum / scene_weight
                # Scene pixel (r, c) lives at buffer (r + pad, c + pad).
                result = blended[pad : pad + scene_h, pad : pad + scene_w]
                return to_host(result).numpy(), (scene_h, scene_w)

    def predict_to_raster(
        self,
        dataset: ChipDataset,
        out_path: T.Union[str, Path],
        reference_profile: T.Optional[dict] = None,
        crs: T.Optional[str] = None,
        reference_image: T.Optional[T.Union[str, Path]] = None,
    ) -> Path:
        """Predict the window chips of ``dataset`` and write the 3-band
        (distance, edge, crop) uint16 x 10000 GeoTIFF at ``out_path``.

        The affine transform comes from the scene bounds the chips carry,
        or from ``reference_image``'s bounds (whose CRS also applies when
        ``crs`` is None). With rasterio, ``reference_profile`` updates the
        GTiff profile; without it the pure-Python codec writes the TIFF,
        and a ``.npz`` sidecar holds ``raster``, ``band_names`` and, where
        known, ``bounds``, ``transform`` (GDAL order) and ``crs``. The
        write holds ``file_lock(out_path)``.
        """
        from .data.geotiff import has_rasterio, read_tiff_band, write_geotiff
        from .utils.locks import file_lock

        ref_bounds = None
        if reference_image is not None:
            _, ref_bounds, _, ref_crs = read_tiff_band(reference_image)
            if crs is None:
                crs = ref_crs

        raster, (scene_h, scene_w) = self.predict_windows(dataset)
        packed = np.clip(raster * SCALE_FACTOR, 0, 65535).astype("uint16")
        packed = np.moveaxis(packed, -1, 0)  # (3, H, W)

        bounds = ref_bounds if ref_bounds is not None else self._scene_bounds
        extras = {}
        if bounds is not None:
            left, bottom, right, top = bounds
            res_x = (right - left) / scene_w
            res_y = (top - bottom) / scene_h
            extras["bounds"] = np.asarray(bounds, dtype="float64")
            extras["transform"] = np.asarray(
                (res_x, 0.0, left, 0.0, -res_y, top), dtype="float64"
            )
        if crs is not None:
            extras["crs"] = np.asarray(str(crs))

        out_path = Path(out_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        with file_lock(out_path):
            write_geotiff(
                out_path, packed, bounds=bounds, crs=crs,
                profile=reference_profile,
            )
            if not has_rasterio():
                np.savez_compressed(
                    out_path.with_suffix(".npz"),
                    raster=packed,
                    band_names=np.asarray([str(b) for b in BAND_NAMES]),
                    **extras,
                )
        return out_path
