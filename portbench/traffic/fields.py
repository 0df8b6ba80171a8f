"""Field-layout training chips: a jittered grid of 4 x 4 to 5 x 5 fields
per chip, each field ringed by a 1-px edge (class 2), about 70% of them
crop (class 1) and the rest background (0); the distance to the field's
boundary, 0 on the edge and 1 at the field's centre line; int16 x 10000
reflectance series. Labels come from a numpy generator, the series from a
generator on ``device``."""

import typing as T

import numpy as np
import torch

SCALE = 10000


def _cuts(rng: np.random.Generator, size: int, parts: int) -> np.ndarray:
    cuts = np.linspace(0, size, parts + 1)
    cuts[1:-1] += rng.uniform(-2.0, 2.0, parts - 1)
    return np.round(cuts).astype(np.int64)


def _layout(rng: np.random.Generator, size: int, crop_share: float):
    """(y, bdist) of one chip, int16, (size, size)."""
    rows, cols = [(4, 4), (4, 5), (5, 4), (5, 5)][int(rng.integers(0, 4))]
    rc, cc = _cuts(rng, size, rows), _cuts(rng, size, cols)
    pix = np.arange(size)
    ri = np.searchsorted(rc, pix, side="right") - 1
    ci = np.searchsorted(cc, pix, side="right") - 1
    dr = np.minimum(pix - rc[ri], rc[ri + 1] - 1 - pix)
    dc = np.minimum(pix - cc[ci], cc[ci + 1] - 1 - pix)
    half_r = (rc[ri + 1] - rc[ri] - 1) / 2.0
    half_c = (cc[ci + 1] - cc[ci] - 1) / 2.0
    dist = np.minimum(dr[:, None], dc[None, :]).astype(np.float64)
    half = np.minimum(half_r[:, None], half_c[None, :])
    crop = rng.random((rows, cols)) < crop_share
    y = np.where(crop[ri[:, None], ci[None, :]], 1, 0)
    y = np.where(dist == 0, 2, y).astype(np.int16)
    bdist = np.round(np.clip(dist / half, 0.0, 1.0) * SCALE).astype(np.int16)
    return y, bdist


def field_chips(
    params: T.Mapping[str, T.Any], seed: int, device
) -> T.Dict[str, np.ndarray]:
    """``params["chips"]`` chips of ``params["chip_size"]`` px with
    ``params["time"]`` steps and ``params["bands"]`` bands: x (N, T, H, W,
    C), y and bdist (N, H, W), all int16 on the host."""
    count, size = int(params["chips"]), int(params["chip_size"])
    steps, bands = int(params["time"]), int(params["bands"])
    rng = np.random.default_rng(seed)
    labels = [_layout(rng, size, float(params["crop_share"])) for _ in range(count)]
    generator = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(
        0, SCALE, (count, steps, size, size, bands), generator=generator,
        device=device, dtype=torch.int16,
    )
    return {
        "x": x.cpu().numpy(),
        "y": np.stack([y for y, _ in labels]),
        "bdist": np.stack([b for _, b in labels]),
    }
