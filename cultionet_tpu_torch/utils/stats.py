"""Streaming statistics over chip datasets (a port-owned copy of
cultionet_tpu/utils/stats.py, numpy only).

Chan-style running mean/variance (mean- or median-of-batch centering), a
streaming per-channel KLL quantile sketch vectorized over channels, and
resumable tallies with on-disk state caches. All state lives in numpy on
the host: statistics passes are IO-bound.

The JAX module enables cache loading through a module-level switch
(``cache_load_enabled``); here the caller passes ``load_cache`` to
``tally_stats``.
"""

import typing as T
from pathlib import Path

import numpy as np


def _flatten_channels_last(a: np.ndarray) -> np.ndarray:
    """(..., C) -> (N, C)."""
    a = np.asarray(a)
    return a.reshape(-1, a.shape[-1]).astype(np.float64)


class Stat:
    """Base: serializable streaming statistic."""

    def state_dict(self) -> T.Dict[str, np.ndarray]:
        raise NotImplementedError

    def load_state_dict(self, state: T.Mapping[str, np.ndarray]) -> None:
        raise NotImplementedError

    def save(self, path: T.Union[str, Path]) -> None:
        np.savez(path, **self.state_dict())

    def load(self, path: T.Union[str, Path]) -> None:
        with np.load(path, allow_pickle=False) as data:
            self.load_state_dict(dict(data))


class Mean(Stat):
    """Running per-channel mean."""

    def __init__(self):
        self.count = 0.0
        self._sum = None

    def add(self, a: np.ndarray) -> None:
        a = _flatten_channels_last(a)
        if a.size == 0:
            return
        if self._sum is None:
            self._sum = a.sum(axis=0)
        else:
            self._sum += a.sum(axis=0)
        self.count += a.shape[0]

    def mean(self) -> np.ndarray:
        return self._sum / max(self.count, 1.0)

    def state_dict(self):
        return {"count": np.asarray(self.count), "sum": self._sum}

    def load_state_dict(self, state):
        self.count = float(state["count"])
        self._sum = np.asarray(state["sum"])


class Variance(Stat):
    """Chan-style running variance with mean- or median-of-batch centering
    (matching reference stats.py:625-683)."""

    def __init__(self, method: str = "mean"):
        if method not in ("mean", "median"):
            raise ValueError(f"method must be 'mean' or 'median', got {method!r}")
        self.method = method
        self.count = 0
        self._center = None
        self._cmom2 = None

    def add(self, a: np.ndarray) -> None:
        a = _flatten_channels_last(a)
        if a.shape[0] == 0:
            return
        batch_count = a.shape[0]
        if self.method == "median":
            batch_reduce = np.median(a, axis=0)
        else:
            batch_reduce = a.mean(axis=0)
        centered = a - batch_reduce

        if self._center is None:
            self.count = batch_count
            self._center = batch_reduce
            self._cmom2 = (centered**2).sum(axis=0)
            return

        oldcount = self.count
        self.count += batch_count
        new_frac = batch_count / self.count
        delta = batch_reduce - self._center
        self._center = self._center + delta * new_frac
        # Textbook Chan parallel-variance combination:
        # M2 = M2_a + M2_b + delta^2 * n_a * n_b / n
        self._cmom2 = (
            self._cmom2
            + (centered**2).sum(axis=0)
            + delta**2 * (oldcount * batch_count / self.count)
        )

    def size(self) -> int:
        return self.count

    def mean(self) -> np.ndarray:
        return np.asarray(self._center)

    def var(self, unbiased: bool = True) -> np.ndarray:
        return self._cmom2 / max(self.count - (1 if unbiased else 0), 1)

    def std(self, unbiased: bool = True) -> np.ndarray:
        return np.sqrt(self.var(unbiased=unbiased))

    def state_dict(self):
        return {
            "count": np.asarray(self.count),
            "center": self._center,
            "cmom2": self._cmom2,
            "method": np.asarray(self.method),
        }

    def load_state_dict(self, state):
        self.count = int(state["count"])
        self._center = np.asarray(state["center"])
        self._cmom2 = np.asarray(state["cmom2"])
        self.method = str(state["method"])


class Quantile(Stat):
    """Streaming per-channel quantiles via a KLL sketch (Karnin-Lall-
    Liberty 2016), matching the reference's sketch (stats.py:236, r=6144).

    One sketch services all C channels simultaneously: every channel
    receives the same item COUNT, so the compactor levels stay length-
    synchronized and each buffer is an (n, C) array whose columns sort
    independently — a fully vectorized multi-channel KLL. Rank error is
    O(1/r) with O(r log(n/r)) memory; unlike a uniform reservoir the
    estimate variance does not grow with stream length.
    """

    def __init__(self, r: int = 6144, seed: int = 42):
        self.r = int(r)  # top-compactor capacity (KLL's k)
        self.count = 0
        self._rng = np.random.default_rng(seed)
        self._levels: T.List[np.ndarray] = []  # level i holds weight-2^i rows
        self._sum = None
        self._chunk = max(self.r, 1024)

    # -- internals -----------------------------------------------------

    def _capacity(self, level: int) -> int:
        """Level capacities decay ~ (2/3)^depth below the top level."""
        depth = len(self._levels) - 1 - level
        return max(int(np.ceil(self.r * (2.0 / 3.0) ** depth)), 2)

    def _compress(self) -> None:
        while True:
            total = sum(buf.shape[0] for buf in self._levels)
            budget = sum(
                self._capacity(i) for i in range(len(self._levels))
            )
            if total <= budget:
                return
            for i, buf in enumerate(self._levels):
                if buf.shape[0] >= self._capacity(i):
                    # Compact: sort columns, keep a random odd/even half at
                    # double weight, promote to level i+1.
                    n = buf.shape[0] - (buf.shape[0] % 2)
                    srt = np.sort(buf[:n], axis=0)
                    offset = int(self._rng.integers(0, 2))
                    promoted = srt[offset::2]
                    leftover = buf[n:]
                    self._levels[i] = leftover
                    if i + 1 == len(self._levels):
                        self._levels.append(
                            np.empty((0, buf.shape[1]), dtype=np.float64)
                        )
                    self._levels[i + 1] = np.concatenate(
                        [self._levels[i + 1], promoted], axis=0
                    )
                    break
            else:  # no level exceeded capacity: done
                return

    # -- public API ------------------------------------------------------

    def add(self, a: np.ndarray) -> None:
        a = _flatten_channels_last(a)
        n = a.shape[0]
        if n == 0:
            return
        if self._sum is None:
            self._sum = np.zeros(a.shape[1], dtype=np.float64)
            self._levels = [np.empty((0, a.shape[1]), dtype=np.float64)]
        self._sum += a.sum(axis=0)
        self.count += n
        for start in range(0, n, self._chunk):
            self._levels[0] = np.concatenate(
                [self._levels[0], a[start : start + self._chunk]], axis=0
            )
            self._compress()

    def quantiles(self, q: T.Union[float, T.Sequence[float]]) -> np.ndarray:
        """Per-channel weighted quantiles over all compactor levels."""
        q_arr = np.atleast_1d(np.asarray(q, dtype=np.float64))
        if self.count == 0 or not any(
            buf.shape[0] for buf in self._levels
        ):
            # Empty sketch (e.g. a resume path loading pre-add cached
            # state): defined result instead of a concatenate crash.
            if self._sum is None:
                raise ValueError(
                    "Quantile.quantiles() called before any add() — "
                    "the sketch is empty and has no channel count"
                )
            out = np.full((len(q_arr), self._sum.shape[0]), np.nan)
            return out if np.ndim(q) else out[0]
        values = np.concatenate(self._levels, axis=0)  # (n, C)
        weights = np.concatenate(
            [
                np.full(buf.shape[0], 2.0**i, dtype=np.float64)
                for i, buf in enumerate(self._levels)
            ]
        )
        n, C = values.shape
        out = np.empty((len(q_arr), C), dtype=np.float64)
        for c in range(C):
            order = np.argsort(values[:, c], kind="stable")
            v = values[order, c]
            w = weights[order]
            cum = np.cumsum(w)
            # midpoint positions (weighted analogue of linear interpolation)
            pos = (cum - 0.5 * w) / cum[-1]
            out[:, c] = np.interp(q_arr, pos, v, left=v[0], right=v[-1])
        result = out if np.ndim(q) else out[0]
        return result

    def median(self) -> np.ndarray:
        return self.quantiles(0.5)

    def mean(self) -> np.ndarray:
        return self._sum / max(self.count, 1)

    def state_dict(self):
        state = {
            "r": np.asarray(self.r),
            "count": np.asarray(self.count),
            "num_levels": np.asarray(len(self._levels)),
            "sum": self._sum,
        }
        for i, buf in enumerate(self._levels):
            state[f"level_{i}"] = buf
        return state

    def load_state_dict(self, state):
        self.r = int(state["r"])
        self.count = int(state["count"])
        self._sum = np.asarray(state["sum"])
        self._levels = [
            np.asarray(state[f"level_{i}"])
            for i in range(int(state["num_levels"]))
        ]


def tally_stats(
    stats: T.Sequence[Stat],
    loader: T.Iterable,
    caches: T.Optional[T.Sequence[T.Union[str, Path]]] = None,
    load_cache: bool = False,
) -> T.Iterator:
    """Iterate ``loader`` for the caller to ``add`` each batch to the
    stats, then save each stat's state to its cache file.

    With ``load_cache`` and every cache file present, each stat's state is
    restored instead and nothing is yielded (the pass is skipped).
    """
    if caches is not None:
        caches = [Path(c) for c in caches]
        if load_cache and all(c.exists() for c in caches):
            for stat, cache in zip(stats, caches):
                stat.load(cache)
            return

    for batch in loader:
        yield batch

    if caches is not None:
        for stat, cache in zip(stats, caches):
            cache.parent.mkdir(parents=True, exist_ok=True)
            stat.save(cache)
