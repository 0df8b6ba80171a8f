"""Scenes for sliding-window predict: int16 x 10000 reflectance series
(T, H, W, C) drawn on ``device`` and handed to the predictor on the
host, as a scene read from disk would be."""

import typing as T

import numpy as np
import torch


def scene_pool(
    params: T.Mapping[str, T.Any], seed: int, device
) -> T.List[np.ndarray]:
    """``params["scene_pool"]`` scenes of ``params["scene_size"]`` px
    squared, ``params["time"]`` steps and ``params["bands"]`` bands."""
    size = int(params["scene_size"])
    shape = (int(params["time"]), size, size, int(params["bands"]))
    generator = torch.Generator(device=device).manual_seed(seed)
    return [
        torch.randint(
            0, 10000, shape, generator=generator, device=device,
            dtype=torch.int16,
        ).cpu().numpy()
        for _ in range(int(params["scene_pool"]))
    ]
