"""Host augmentation: one named augmenter per sample, parcel-aware (port of
cultionet_tpu/augment/augmenters.py).

15 named augmenters; each transforms the batch and re-clips x to
[1e-9, 1] (and bdist to [0, 1]). The temporal augmenters (roll, tswarp,
tsnoise, tsdrift, tspeaks) act per field parcel, a connected component of
``y == crop_value``: the transform is computed on the whole chip and
masked to the parcel's pixels.

All randomness comes from the numpy generator ``rng``, in the JAX
package's order: the same choices, parameters and key seeds, draw for
draw. Where JAX seeds a ``jax.random.PRNGKey`` with ``rng.integers(0,
2**31 - 1)``, the port seeds a CPU ``torch.Generator`` with the same
integer. So the generator's state after a call equals JAX's, and the
noisy augmenters match JAX in law, not in value. The work runs on CPU
tensors, in the loader's thread; the card never sees it.
"""

import typing as T

import numpy as np
import torch

from .batch import Batch
from . import augment_functional as AF

AUGMENTATION_NAMES = (
    "tswarp",
    "tsnoise",
    "tsdrift",
    "tspeaks",
    "rot90",
    "rot180",
    "rot270",
    "roll",
    "fliplr",
    "flipud",
    "gaussian",
    "saltpepper",
    "cropresize",
    "perlin",
    "none",
)

SPATIAL_NAMES = ("rot90", "rot180", "rot270", "fliplr", "flipud", "cropresize")
TEMPORAL_NAMES = ("tswarp", "tsnoise", "tsdrift", "tspeaks", "roll")


def label_segments(y: np.ndarray, crop_value: int = 1) -> np.ndarray:
    """Connected components of the crop mask (4-connectivity)."""
    from scipy import ndimage

    segments, _ = ndimage.label(y == crop_value)
    return segments.astype(np.int32)


def _finalize(batch: Batch) -> Batch:
    """Clip x to [1e-9, 1] and bdist to [0, 1]."""
    out = batch.replace(x=torch.clamp(batch.x, 1e-9, 1.0))
    if batch.bdist is not None:
        out = out.replace(bdist=torch.clamp(batch.bdist, 0.0, 1.0))
    return out


class Augmenters:
    """Apply a sequence of named augmentations to a Batch of CPU tensors."""

    def __init__(
        self,
        augmentations: T.Sequence[str],
        rng: T.Optional[np.random.Generator] = None,
        random_seed: T.Optional[int] = None,
        crop_value: int = 1,
    ):
        unknown = set(augmentations) - set(AUGMENTATION_NAMES)
        if unknown:
            raise ValueError(f"Unknown augmentations: {sorted(unknown)}")
        self.augmentations = list(augmentations)
        self.rng = rng if rng is not None else np.random.default_rng(random_seed)
        self.crop_value = crop_value

    def __call__(self, batch: Batch) -> Batch:
        for name in self.augmentations:
            batch = self._apply_one(name, batch)
        return batch

    # ------------------------------------------------------------------

    def _generator(self) -> torch.Generator:
        """A CPU generator seeded where JAX draws a PRNGKey's seed."""
        seed = int(self.rng.integers(0, 2**31 - 1))
        return torch.Generator().manual_seed(seed)

    def _apply_one(self, name: str, batch: Batch) -> Batch:
        if name == "none":
            return batch

        if name in ("rot90", "rot180", "rot270"):
            k = {"rot90": 1, "rot180": 2, "rot270": 3}[name]
            x, y, bdist = AF.rotate(batch.x, batch.y, batch.bdist, k=k)
            return _finalize(batch.replace(x=x, y=y, bdist=bdist))

        if name in ("fliplr", "flipud"):
            fn = AF.fliplr if name == "fliplr" else AF.flipud
            x, y, bdist = fn(batch.x, batch.y, batch.bdist)
            return _finalize(batch.replace(x=x, y=y, bdist=bdist))

        if name == "gaussian":
            sigma = torch.tensor(self.rng.uniform(0.2, 0.5), dtype=batch.x.dtype)
            return _finalize(batch.replace(x=AF.gaussian_blur(batch.x, sigma)))

        if name == "saltpepper":
            noise = AF.draw_noise(batch.x, self._generator())
            return _finalize(
                batch.replace(x=AF.gaussian_noise(batch.x, noise, sigma=0.01))
            )

        if name == "cropresize":
            div = int(self.rng.choice([2, 4]))
            row0, col0 = AF.draw_crop_origin(
                self._generator(), batch.height, batch.width, div
            )
            x, y, bdist = AF.crop_resize(
                batch.x, batch.y, batch.bdist, row0, col0, div=div
            )
            return _finalize(batch.replace(x=x, y=y, bdist=bdist))

        if name == "perlin":
            res = int(self.rng.choice([2, 5, 10]))
            theta, phi = AF.draw_perlin_lattices(self._generator(), (1, res, res))
            noise = AF.perlin_noise_3d(
                theta,
                phi,
                shape=(batch.num_time, batch.height, batch.width),
                res=(1, res, res),
                out_range=(-0.03, 0.03),
            )
            x = batch.x + noise[None, :, :, :, None].to(batch.x.dtype)
            return _finalize(batch.replace(x=x))

        if name in TEMPORAL_NAMES:
            return _finalize(self._apply_temporal(name, batch))

        raise ValueError(f"Unhandled augmentation: {name}")

    def _noisy(self, x: torch.Tensor) -> torch.Tensor:
        """x plus tsaug.AddNoise at a drawn scale (key first, then scale,
        as JAX evaluates the call's arguments)."""
        generator = self._generator()
        scale = float(self.rng.uniform(0.01, 0.05))
        return AF.add_time_noise(x, AF.draw_noise(x, generator), scale=scale)

    def _transform(self, name: str, x_b: torch.Tensor) -> torch.Tensor:
        """One parcel's temporal transform of the whole chip ``x_b``."""
        if name == "roll":
            limit = int(x_b.shape[1] * 0.25)
            shift = int(self.rng.choice(range(-limit, limit + 1)))
            return AF.roll_time(x_b, shift)
        if name == "tswarp":
            generator = self._generator()
            n_speed_change = int(self.rng.integers(1, 3))
            max_speed_ratio = float(self.rng.uniform(1.1, 1.5))
            speeds = AF.draw_time_warp_speeds(
                generator, n_speed_change, max_speed_ratio
            )
            return self._noisy(AF.time_warp(x_b, speeds))
        if name == "tspeaks":
            speeds = AF.draw_time_warp_speeds(self._generator())
            return self._noisy(AF.time_peaks(x_b, speeds))
        if name == "tsnoise":
            return self._noisy(x_b)
        if name == "tsdrift":
            generator = self._generator()
            max_drift = float(self.rng.uniform(0.05, 0.1))
            n_drift_points = int(self.rng.integers(1, 6))
            steps = AF.draw_drift_steps(generator, n_drift_points)
            return self._noisy(AF.time_drift(x_b, steps, max_drift=max_drift))
        raise ValueError(name)

    def _apply_temporal(self, name: str, batch: Batch) -> Batch:
        """Apply a temporal transform independently per field parcel."""
        y_np = batch.y.numpy()
        x = batch.x.clone()
        for b in range(y_np.shape[0]):
            segments = torch.from_numpy(
                label_segments(y_np[b], crop_value=self.crop_value)
            )
            for label in range(1, int(segments.max()) + 1):
                x_b = x[b : b + 1]
                transformed = self._transform(name, x_b)
                mask = (segments == label)[None, None, :, :, None]
                x[b : b + 1] = torch.where(
                    mask, torch.clamp(transformed, 0.0, 1.0), x_b
                )
        return batch.replace(x=x)
