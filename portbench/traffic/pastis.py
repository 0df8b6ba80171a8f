"""PASTIS-shaped patches (Garnot & Landrieu 2021: 128 x 128 px Sentinel-2
patches, 10 bands, 38 to 61 acquisitions a patch, 20 classes), made from
the seed. Each patch draws its date count uniformly from [``min_time``,
``time``] (at most ``time``) and that many distinct sorted days in [0,
``day_span``), padded to ``time`` dates with zeros; its labels are the
field layout of ``fields.py`` (a jittered grid of 4 x 4 to 5 x 5 fields
ringed by 1-px edges): each field one class in 1-18, about ``void_share``
of them the void class 19, the edges background 0. The reflectance series
(int16 x 10000) is drawn on ``device``, zero at the pad dates; labels and
dates come from a numpy generator."""

import typing as T

import numpy as np
import torch

from .fields import SCALE, _cuts

CLASSES = 20
VOID = 19


def _labels(rng: np.random.Generator, size: int, void_share: float) -> np.ndarray:
    rows, cols = [(4, 4), (4, 5), (5, 4), (5, 5)][int(rng.integers(0, 4))]
    rc, cc = _cuts(rng, size, rows), _cuts(rng, size, cols)
    pix = np.arange(size)
    ri = np.searchsorted(rc, pix, side="right") - 1
    ci = np.searchsorted(cc, pix, side="right") - 1
    edge_r = (pix == rc[ri]) | (pix == rc[ri + 1] - 1)
    edge_c = (pix == cc[ci]) | (pix == cc[ci + 1] - 1)
    classes = rng.integers(1, VOID, size=(rows, cols))
    classes = np.where(rng.random((rows, cols)) < void_share, VOID, classes)
    y = classes[ri[:, None], ci[None, :]]
    return np.where(edge_r[:, None] | edge_c[None, :], 0, y).astype(np.int16)


def pastis_patches(
    params: T.Mapping[str, T.Any], seed: int, device
) -> T.Dict[str, T.Any]:
    """``params["chips"]`` patches of ``params["chip_size"]`` px and
    ``params["bands"]`` bands: x (N, T, H, W, C) int16 on ``device``; y (N,
    H, W), dates (N, T) and date_count (N,), int16 numpy arrays."""
    count, size = int(params["chips"]), int(params["chip_size"])
    steps, bands = int(params["time"]), int(params["bands"])
    low = min(int(params["min_time"]), steps)
    rng = np.random.default_rng(seed)
    date_count = rng.integers(low, steps + 1, size=count)
    dates = np.zeros((count, steps), np.int16)
    for i, n in enumerate(date_count):
        dates[i, :n] = np.sort(rng.choice(int(params["day_span"]), size=n, replace=False))
    y = np.stack([_labels(rng, size, float(params["void_share"])) for _ in range(count)])
    generator = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(
        0, SCALE, (count, steps, size, size, bands), generator=generator,
        device=device, dtype=torch.int16,
    )
    counts = torch.from_numpy(date_count).to(device)
    real = torch.arange(steps, device=device)[None] < counts[:, None]
    x *= real[:, :, None, None, None].to(torch.int16)
    return {"x": x, "y": y, "dates": dates, "date_count": date_count.astype(np.int16)}
