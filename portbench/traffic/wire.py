"""Wire-format serving requests: batches of int16 x 10000 windows
(B, T, S, S, C) with their chips' lat/lon centroids, a pool the caller
cycles through."""

import typing as T

import numpy as np
import torch


def wire_pool(
    params: T.Mapping[str, T.Any], seed: int, device
) -> T.List[T.Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """``params["pool"]`` requests of ``params["batch"]`` windows of
    ``params["window"]`` px squared: (x int16, lat float32, lon float32)
    on the host."""
    batch, size = int(params["batch"]), int(params["window"])
    shape = (batch, int(params["time"]), size, size, int(params["bands"]))
    rng = np.random.default_rng(seed)
    generator = torch.Generator(device=device).manual_seed(seed)
    pool = []
    for _ in range(int(params["pool"])):
        x = torch.randint(
            0, 10000, shape, generator=generator, device=device,
            dtype=torch.int16,
        ).cpu().numpy()
        lat = rng.uniform(-60.0, 70.0, batch).astype(np.float32)
        lon = rng.uniform(-180.0, 180.0, batch).astype(np.float32)
        pool.append((x, lat, lon))
    return pool
