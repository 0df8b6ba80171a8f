"""Synthetic chips for tests and the chip smoke run (port of
cultionet_tpu/data/synthetic.py::create_batch): random (B, T, H, W, C)
series, labels in {-1, 0, 1, 2} (weak label -1 included) and random
boundary distances, drawn with numpy in the JAX function's order, so one
seed gives both packages the same ``x``, ``y`` and ``bdist``."""

import typing as T

import numpy as np
import torch

from .batch import Batch


def create_batch(
    num_channels: int = 3,
    num_time: int = 12,
    height: int = 20,
    width: int = 20,
    batch_size: int = 1,
    rng: T.Optional[np.random.Generator] = None,
) -> Batch:
    if rng is None:
        rng = np.random.default_rng(100)

    x = rng.random(
        (batch_size, num_time, height, width, num_channels), dtype=np.float32
    )
    y = rng.integers(low=-1, high=3, size=(batch_size, height, width))
    bdist = rng.random((batch_size, height, width), dtype=np.float32)
    # The JAX batch then draws bounds, a chip id and a year; draw them too
    # so that ``rng`` leaves here in the same state.
    rng.uniform(-180, 180, size=batch_size)
    rng.uniform(0, 1, size=batch_size)
    rng.uniform(-90, 89, size=batch_size)
    rng.uniform(0, 1, size=batch_size)
    rng.integers(low=0, high=99_999)
    rng.choice([2020, 2021, 2022, 2023])

    return Batch(
        x=torch.from_numpy(x),
        y=torch.from_numpy(y.astype(np.int32)),
        bdist=torch.from_numpy(bdist),
    )
