"""Spatially balanced splitting and k-fold iteration over chip centroids
(a port-owned copy of cultionet_tpu/data/spatial.py, numpy only).

A plain-numpy quadtree: recursively partition the centroid bounding box
into quadrants until cells are small, then sample across cells round-robin,
a spatially balanced selection without geo dependencies (GRTS-style).
"""

import typing as T

import numpy as np


def _quadtree_cells(
    points: np.ndarray, max_per_cell: int
) -> T.List[np.ndarray]:
    """Recursively split points (N, 2) into quadrants; return index groups."""

    def split(indices: np.ndarray, depth: int) -> T.List[np.ndarray]:
        if len(indices) <= max_per_cell or depth > 12:
            return [indices]
        pts = points[indices]
        mid_x = (pts[:, 0].min() + pts[:, 0].max()) / 2.0
        mid_y = (pts[:, 1].min() + pts[:, 1].max()) / 2.0
        cells = []
        for right in (False, True):
            for top in (False, True):
                sel = (
                    ((pts[:, 0] > mid_x) == right)
                    & ((pts[:, 1] > mid_y) == top)
                )
                if sel.any():
                    sub = indices[sel]
                    if len(sub) == len(indices):
                        return [indices]  # degenerate (coincident points)
                    cells.extend(split(sub, depth + 1))
        return cells

    return split(np.arange(len(points)), 0)


def spatially_balanced_sample(
    centroids: np.ndarray,
    num_samples: int,
    rng: T.Optional[np.random.Generator] = None,
    max_per_cell: int = 4,
) -> np.ndarray:
    """Pick ``num_samples`` indices spread across space: round-robin over
    shuffled quadtree cells."""
    if rng is None:
        rng = np.random.default_rng(42)
    num_samples = min(num_samples, len(centroids))

    cells = _quadtree_cells(np.asarray(centroids, dtype=np.float64), max_per_cell)
    cells = [rng.permutation(cell) for cell in cells]
    order = rng.permutation(len(cells))

    chosen: T.List[int] = []
    round_idx = 0
    while len(chosen) < num_samples:
        progressed = False
        for cell_id in order:
            cell = cells[cell_id]
            if round_idx < len(cell):
                chosen.append(int(cell[round_idx]))
                progressed = True
                if len(chosen) >= num_samples:
                    break
        if not progressed:
            break
        round_idx += 1
    return np.asarray(sorted(chosen), dtype=np.int64)


def spatial_kfold_indices(
    centroids: np.ndarray,
    k: int,
    rng: T.Optional[np.random.Generator] = None,
) -> T.List[np.ndarray]:
    """Partition indices into k spatially clustered folds (quadtree cells
    greedily packed into folds) — the reference's spatial k-fold CV iterator
    (datasets.py:259-273)."""
    if rng is None:
        rng = np.random.default_rng(42)
    n = len(centroids)
    target = int(np.ceil(n / k))
    cells = _quadtree_cells(
        np.asarray(centroids, dtype=np.float64), max_per_cell=max(1, target // 2)
    )
    if len(cells) < k:
        # Degenerate geometry (e.g. coincident centroids): random k-fold.
        order = rng.permutation(n)
        return [
            np.asarray(sorted(fold), dtype=np.int64)
            for fold in np.array_split(order, k)
            if len(fold)
        ]
    order = rng.permutation(len(cells))

    folds: T.List[T.List[int]] = [[] for _ in range(k)]
    fold_id = 0
    for cell_id in order:
        folds[fold_id].extend(int(i) for i in cells[cell_id])
        # move to the emptiest fold
        fold_id = int(np.argmin([len(f) for f in folds]))
    return [np.asarray(sorted(f), dtype=np.int64) for f in folds if len(f)]
