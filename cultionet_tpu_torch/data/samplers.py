"""Epoch-wise random subset sampling (port of
cultionet_tpu/data/samplers.py)."""

import typing as T

import numpy as np


class EpochRandomSampler:
    """Yields a fresh random subset of dataset indices each epoch, drawn
    from its own numpy generator (the JAX sampler's draws for one seed)."""

    def __init__(
        self,
        dataset_size: int,
        num_samples: T.Optional[int] = None,
        seed: int = 42,
    ):
        self.dataset_size = dataset_size
        self.num_samples = (
            dataset_size if num_samples is None else min(num_samples, dataset_size)
        )
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self.num_samples

    def __iter__(self) -> T.Iterator[int]:
        return iter(
            self.rng.permutation(self.dataset_size)[: self.num_samples]
        )
