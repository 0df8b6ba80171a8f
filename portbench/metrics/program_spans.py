"""Readings of the program's own spans and counters
(``cultionet_tpu_torch/utils/profiling.py``), which record only while a
profiler is active: inside the traced run's profiled iterations, all in
the window. Each returns None where the program records no such root
span (a program without the spans, or an untraced run)."""

import typing as T


def _root_totals(root: str) -> T.Optional[dict]:
    from cultionet_tpu_torch.utils import profiling

    totals = getattr(profiling, "totals", None)
    if totals is None:
        return None
    found = totals()
    if found.get(root, {}).get("count", 0) == 0:
        return None
    return found


def self_ms_per_unit(names: T.Sequence[str], root: str) -> T.Optional[float]:
    """The self ms of the spans ``names``, summed, per ``root`` span."""
    found = _root_totals(root)
    if found is None:
        return None
    self_ns = sum(found[n]["self_ns"] for n in names if n in found)
    return self_ns / 1e6 / found[root]["count"]


def count_per_unit(counter: str, root: str) -> T.Optional[float]:
    """How far the program's counter ``counter`` moved inside the ``root``
    spans, per ``root`` span."""
    found = _root_totals(root)
    if found is None:
        return None
    return found[root]["counts"].get(counter, 0) / found[root]["count"]
