"""Chip datasets: file-backed training data (port of
cultionet_tpu/data/datasets.py::ChipDataset).

A file-list dataset over ``root/processed/data*.npz`` chips: 1/10000
scaling and clipping, the optional Dynamic World log transform, z-score
normalization, per-chip lat/lon centroids, a random or spatially balanced
train/validation split, a split or folds by named partition polygons
from a user file (GeoJSON or GeoPackage), spatial k-fold iteration and a
parallel dimension audit, and host augmentation: with probability ``augment_prob`` a
labelled chip goes through one augmenter drawn from ``augmentations``
(``augment/``), from the dataset's numpy generator in the JAX package's
order. All host work runs on CPU numpy arrays and tensors; a chip leaves as
a ``Batch`` of CPU tensors. Reference joblib ``data*.pt`` chips are listed
and read beside the ``.npz`` ones (``Batch.from_reference_file``).
"""

import typing as T
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..augment import AUGMENTATION_NAMES, Augmenters
from ..errors import TensorShapeError
from .batch import Batch
from .constant import SCALE_FACTOR
from .spatial import spatial_kfold_indices, spatially_balanced_sample


class ChipDataset:
    """Dataset over chip files under ``root/processed`` (or ``root``)."""

    def __init__(
        self,
        root: T.Union[str, Path],
        pattern: str = "data*",
        norm_values=None,
        augment_prob: float = 0.0,
        augmentations: T.Optional[T.Sequence[str]] = None,
        log_transform: bool = False,
        random_seed: int = 42,
        files: T.Optional[T.Sequence[Path]] = None,
        preload: bool = False,
    ):
        self.root = Path(root)
        self.pattern = pattern
        self.norm_values = norm_values
        self.augment_prob = augment_prob
        self.log_transform = log_transform
        self.random_seed = random_seed
        self.rng = np.random.default_rng(random_seed)
        if augmentations is None:
            augmentations = [n for n in AUGMENTATION_NAMES if n != "none"]
        self.augmentations = list(augmentations)
        if files is not None:
            self.files = [Path(f) for f in files]
        else:
            processed = self.root / "processed"
            search_dir = processed if processed.is_dir() else self.root
            self.files = sorted(
                list(search_dir.glob(f"{pattern}.npz"))
                + list(search_dir.glob(f"{pattern}.pt"))
            )
        # Keep raw chips in host memory so later epochs skip file reads.
        self.preload = bool(preload)
        self._cache: T.Dict[Path, Batch] = {}

    def __len__(self) -> int:
        return len(self.files)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def _subset(self, files: T.Sequence[Path]) -> "ChipDataset":
        return ChipDataset(
            root=self.root,
            pattern=self.pattern,
            norm_values=self.norm_values,
            augment_prob=self.augment_prob,
            augmentations=self.augmentations,
            log_transform=self.log_transform,
            random_seed=self.random_seed,
            files=files,
            preload=self.preload,
        )

    def shuffle(self, rng: T.Optional[np.random.Generator] = None):
        rng = rng or self.rng
        order = rng.permutation(len(self.files))
        self.files = [self.files[i] for i in order]

    def index_select(self, indices: T.Sequence[int]) -> "ChipDataset":
        return self._subset([self.files[int(i)] for i in indices])

    # -- loading ---------------------------------------------------------

    @staticmethod
    def _scale(values, clip_min: float, clip_max: float) -> np.ndarray:
        """1/10000 scaling for int16-packed chips (and for float chips with
        values above 2); then clipping, in fp32."""
        arr = np.asarray(values)
        if np.issubdtype(arr.dtype, np.integer) or (
            float(arr.max()) > 2.0 if arr.size else False
        ):
            arr = arr.astype(np.float32) / SCALE_FACTOR
        return np.clip(arr.astype(np.float32), clip_min, clip_max)

    def load_file(self, path: Path) -> Batch:
        """The chip at ``path``; under ``preload`` a copy of the cached
        chip's arrays, so that nothing downstream can change the cache."""
        if not self.preload:
            return Batch.from_file(path)
        cached = self._cache.get(path)
        if cached is None:
            cached = Batch.from_file(path)
            self._cache[path] = cached
        return cached.replace(
            **{name: value.clone() for name, value in cached.tensors().items()}
        )

    def __getitem__(self, idx: int) -> Batch:
        batch = self.load_file(self.files[int(idx)])
        batch = batch.replace(
            x=torch.from_numpy(self._scale(batch.x.numpy(), 1e-9, 1.0))
        )
        if batch.bdist is not None:
            batch = batch.replace(
                bdist=torch.from_numpy(
                    self._scale(batch.bdist.numpy(), 1e-9, 1.0)
                )
            )
        if batch.y is not None and self.augment_prob > 0:
            if self.rng.random() > (1.0 - self.augment_prob):
                name = str(self.rng.choice(self.augmentations))
                batch = Augmenters([name], rng=self.rng)(batch)
        if self.log_transform:
            # Dynamic World log transform.
            x = batch.x.numpy()
            x = np.maximum(np.log(x * np.float32(50.0) + np.float32(1.0)), 1e-9)
            batch = batch.replace(x=torch.from_numpy(x.astype(np.float32)))
        if self.norm_values is not None:
            batch = self.norm_values(batch)
        return batch.with_centroids()

    # -- splits ------------------------------------------------------------

    def centroids(self) -> np.ndarray:
        """(N, 2) lon/lat chip centroids from geo bounds (metadata only)."""
        points = np.zeros((len(self.files), 2), dtype=np.float64)
        for i, path in enumerate(self.files):
            batch = Batch.read_meta(path)
            if batch.left is None:
                continue
            points[i, 0] = float(batch.left[0] + batch.right[0]) / 2.0
            points[i, 1] = float(batch.bottom[0] + batch.top[0]) / 2.0
        return points

    def split_train_val(
        self,
        val_frac: float,
        spatial_balance: bool = False,
        rng: T.Optional[np.random.Generator] = None,
    ) -> T.Tuple["ChipDataset", "ChipDataset"]:
        """Random or spatially balanced train/validation split, drawn from
        ``rng`` (the dataset's own generator by default)."""
        rng = rng or self.rng
        n = len(self.files)
        num_val = max(1, int(round(n * val_frac)))
        if spatial_balance:
            val_idx = spatially_balanced_sample(
                self.centroids(), num_val, rng=rng
            )
        else:
            val_idx = np.sort(rng.permutation(n)[:num_val])
        val_mask = np.zeros(n, dtype=bool)
        val_mask[val_idx] = True
        train_files = [f for f, v in zip(self.files, val_mask) if not v]
        val_files = [f for f, v in zip(self.files, val_mask) if v]
        val_ds = self._subset(val_files)
        val_ds.augment_prob = 0.0  # no augmentation on validation
        return self._subset(train_files), val_ds

    # -- named spatial partitions ----------------------------------------

    def get_spatial_partitions(
        self, spatial_partitions: T.Union[str, Path]
    ) -> T.List[T.Tuple[T.Any, dict]]:
        """Load a user partition polygon file (GeoPackage or GeoJSON) as
        (exterior ring, attributes) features. The polygons must share the
        chips' CRS (nothing reprojects them)."""
        from .vector import read_feature_table

        self.spatial_partitions = read_feature_table(spatial_partitions)
        return self.spatial_partitions

    def query_partition_by_name(
        self, partition_column: str, partition_name: str
    ) -> T.List[int]:
        """Indices of the chips whose centroid lies inside the partition
        polygon(s) whose ``partition_column`` is ``partition_name``."""
        from .vector import points_in_ring

        if getattr(self, "spatial_partitions", None) is None:
            raise ValueError("call get_spatial_partitions(file) first")
        rings = [
            ring
            for ring, props in self.spatial_partitions
            if str(props.get(partition_column)) == str(partition_name)
        ]
        if not rings:
            return []
        points = self.centroids()
        inside = np.zeros(len(points), dtype=bool)
        for ring in rings:
            inside |= points_in_ring(points, ring)
        return np.nonzero(inside)[0].tolist()

    def split_by_partition(
        self,
        spatial_partitions: T.Union[str, Path],
        partition_name: str,
        partition_column: str = "name",
    ) -> T.Tuple["ChipDataset", "ChipDataset"]:
        """Train/validation split by a named partition: the chips inside
        its polygon(s) validate, the rest train. Raises ``ValueError`` when
        the partition holds no chip."""
        self.get_spatial_partitions(spatial_partitions)
        val_idx = self.query_partition_by_name(partition_column, partition_name)
        if not val_idx:
            raise ValueError(f"Partition {partition_name!r} contains no chips")
        val_mask = np.zeros(len(self.files), dtype=bool)
        val_mask[val_idx] = True
        train_files = [f for f, v in zip(self.files, val_mask) if not v]
        val_files = [f for f, v in zip(self.files, val_mask) if v]
        val_ds = self._subset(val_files)
        val_ds.augment_prob = 0.0
        return self._subset(train_files), val_ds

    def partition_kfoldcv_iter(
        self,
        spatial_partitions: T.Union[str, Path],
        partition_column: str = "name",
    ) -> T.Iterator[T.Tuple[str, "ChipDataset", "ChipDataset"]]:
        """Yield (name, train_ds, val_ds), one fold per named partition in
        file order; a partition holding no chip is skipped."""
        self.get_spatial_partitions(spatial_partitions)
        names = []
        for _, props in self.spatial_partitions:
            name = props.get(partition_column)
            if name is not None and name not in names:
                names.append(name)
        for name in names:
            try:
                train_ds, val_ds = self.split_by_partition(
                    spatial_partitions, name, partition_column
                )
            except ValueError:
                continue
            yield str(name), train_ds, val_ds

    def spatial_kfoldcv_iter(
        self, k: int, rng: T.Optional[np.random.Generator] = None
    ) -> T.Iterator[T.Tuple[str, "ChipDataset", "ChipDataset"]]:
        """Yield (fold_name, train_ds, val_ds) over spatial folds."""
        folds = spatial_kfold_indices(self.centroids(), k, rng=rng)
        for fold_num, fold_idx in enumerate(folds):
            mask = np.zeros(len(self.files), dtype=bool)
            mask[fold_idx] = True
            train_files = [f for f, m in zip(self.files, mask) if not m]
            val_files = [f for f, m in zip(self.files, mask) if m]
            if not train_files or not val_files:
                continue
            val_ds = self._subset(val_files)
            val_ds.augment_prob = 0.0
            yield f"fold{fold_num}", self._subset(train_files), val_ds

    def check_dims(
        self,
        expected_time: T.Optional[int] = None,
        expected_channels: T.Optional[int] = None,
        expected_height: T.Optional[int] = None,
        expected_width: T.Optional[int] = None,
        num_workers: int = 4,
        delete_mismatches: bool = False,
    ) -> T.List[Path]:
        """Parallel shape audit; returns the mismatching files (deleting
        them when asked), else raises ``TensorShapeError``. Time and
        channels default to the first readable chip's."""
        ref_time, ref_channels = expected_time, expected_channels

        def audit(path: Path):
            try:
                batch = self.load_file(path)
            except (OSError, ValueError, KeyError, NotImplementedError):
                return path, -1, -1, -1, -1
            return (
                path, batch.num_time, batch.num_channels, batch.height,
                batch.width,
            )

        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            results = list(pool.map(audit, self.files))
        if ref_time is None or ref_channels is None:
            for _, t, c, _, _ in results:
                if t > 0:
                    ref_time = ref_time or t
                    ref_channels = ref_channels or c
                    break
        mismatched = [
            path
            for path, t, c, h, w in results
            if (t, c) != (ref_time, ref_channels)
            or (expected_height is not None and h != expected_height)
            or (expected_width is not None and w != expected_width)
        ]
        if mismatched and delete_mismatches:
            for path in mismatched:
                path.unlink(missing_ok=True)
            gone = set(mismatched)
            self.files = [f for f in self.files if f not in gone]
        elif mismatched:
            raise TensorShapeError(
                f"{len(mismatched)} chips have mismatched dims "
                f"(expected T={ref_time}, C={ref_channels}): "
                f"{[p.name for p in mismatched[:5]]}..."
            )
        return mismatched
