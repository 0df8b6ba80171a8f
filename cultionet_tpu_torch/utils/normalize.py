"""Dataset normalization values: streaming per-channel statistics and the
z-score (port of cultionet_tpu/utils/normalize.py::NormValues).

One pass over the train split computes the per-channel center (median by
default) and std, 5% / 95% quantile bounds and the crop / edge pixel
counts; ``transform`` z-scores ``batch.x``; ``to_file`` / ``from_file``
keep the ``.npz`` layout of the JAX package (the ``last.norm`` sidecar), so
either package reads the other's file.
"""

import typing as T
from pathlib import Path

import numpy as np
import torch

from ..data.batch import Batch
from .stats import Quantile, Variance, tally_stats


class NormValues:
    def __init__(
        self,
        dataset_mean: np.ndarray,  # (C,)
        dataset_std: np.ndarray,  # (C,)
        dataset_crop_counts: np.ndarray,
        dataset_edge_counts: np.ndarray,
        num_channels: int,
        lower_bound: T.Optional[np.ndarray] = None,
        upper_bound: T.Optional[np.ndarray] = None,
    ):
        self.dataset_mean = np.asarray(dataset_mean, dtype=np.float32)
        self.dataset_std = np.asarray(dataset_std, dtype=np.float32)
        self.dataset_crop_counts = np.asarray(dataset_crop_counts)
        self.dataset_edge_counts = np.asarray(dataset_edge_counts)
        self.num_channels = int(num_channels)
        self.lower_bound = (
            None if lower_bound is None else np.asarray(lower_bound)
        )
        self.upper_bound = (
            None if upper_bound is None else np.asarray(upper_bound)
        )

    def __repr__(self):
        return (
            f"NormValues(mean={self.dataset_mean}, std={self.dataset_std}, "
            f"crop_counts={self.dataset_crop_counts}, "
            f"edge_counts={self.dataset_edge_counts})"
        )

    def __call__(self, batch: Batch) -> Batch:
        return self.transform(batch)

    def _moments(self, x: torch.Tensor):
        mean = torch.as_tensor(self.dataset_mean, dtype=x.dtype, device=x.device)
        std = torch.as_tensor(self.dataset_std, dtype=x.dtype, device=x.device)
        return mean, std

    def transform(self, batch: Batch) -> Batch:
        """z = (x - center) / std, broadcast over (B, T, H, W, C)."""
        mean, std = self._moments(batch.x)
        return batch.replace(x=(batch.x - mean) / std)

    def inverse_transform(self, batch: Batch) -> Batch:
        mean, std = self._moments(batch.x)
        return batch.replace(x=batch.x * std + mean)

    @property
    def data_dict(self) -> dict:
        return {
            "dataset_mean": self.dataset_mean,
            "dataset_std": self.dataset_std,
            "dataset_crop_counts": self.dataset_crop_counts,
            "dataset_edge_counts": self.dataset_edge_counts,
            "num_channels": np.asarray(self.num_channels),
            "lower_bound": self.lower_bound,
            "upper_bound": self.upper_bound,
        }

    def to_file(self, filename: T.Union[Path, str]) -> None:
        path = Path(filename)
        path.parent.mkdir(parents=True, exist_ok=True)
        payload = {k: v for k, v in self.data_dict.items() if v is not None}
        np.savez(path, **payload)

    @classmethod
    def from_file(cls, filename: T.Union[Path, str]) -> "NormValues":
        with np.load(Path(filename), allow_pickle=False) as data:
            kwargs = {k: data[k] for k in data.files}
        return cls(**kwargs)

    @classmethod
    def from_dataset(
        cls,
        dataset: T.Iterable[Batch],
        class_info: T.Dict[str, int],
        centering: str = "median",
        lower_quantile: float = 0.05,
        upper_quantile: float = 0.95,
        cache_dir: T.Optional[T.Union[str, Path]] = None,
        progress: bool = False,
    ) -> "NormValues":
        """One streaming pass over (already scaled) batches. With
        ``cache_dir`` the statistics' states are saved there, and a later
        call with the same directory restores them instead of reading."""
        max_crop_class = class_info["max_crop_class"]
        edge_class = class_info["edge_class"]

        stat_var = Variance(method=centering)
        stat_q = Quantile(r=1024 * 6)
        crop_counts = np.zeros(max_crop_class + 1, dtype=np.int64)
        edge_counts = np.zeros(2, dtype=np.int64)

        caches = None
        if cache_dir is not None:
            cache_dir = Path(cache_dir)
            caches = (cache_dir / "_var.npz", cache_dir / "_q.npz")

        iterator: T.Iterable = dataset
        if progress:
            try:
                from tqdm import tqdm

                iterator = tqdm(dataset, desc="Calculating stats")
            except ImportError:
                pass

        for batch in tally_stats(
            stats=(stat_var, stat_q),
            loader=iterator,
            caches=caches,
            load_cache=cache_dir is not None,
        ):
            # (B, T, H, W, C) -> (N, C)
            x = np.asarray(batch.x).reshape(-1, batch.x.shape[-1])
            stat_var.add(x)
            stat_q.add(x)

            y = np.asarray(batch.y)
            crop_counts[0] += int(((y == 0) | (y == edge_class)).sum())
            for i in range(1, edge_class):
                crop_counts[i] += int((y == i).sum())
            edge_counts[0] += int(((y >= 0) & (y != edge_class)).sum())
            edge_counts[1] += int((y == edge_class).sum())

        data_stds = stat_var.std()
        if centering == "mean":
            data_means = stat_q.mean()
        else:
            data_means = stat_q.median()

        return cls(
            dataset_mean=data_means,
            dataset_std=data_stds,
            lower_bound=stat_q.quantiles(lower_quantile),
            upper_bound=stat_q.quantiles(upper_quantile),
            dataset_crop_counts=crop_counts,
            dataset_edge_counts=edge_counts,
            num_channels=len(data_means),
        )
