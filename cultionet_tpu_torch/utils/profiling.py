"""Tracing of the port: spans and counters at its layer boundaries, and
the command line's ``--profiler DIR`` (the port's counterpart of
cultionet_tpu/utils/profiling.py::profile_trace, on ``torch.profiler``).

- ``span(name)``: a host range around one layer's part of a unit of work
  (a train step, a predicted scene, a served call). Tracing is on exactly
  while a ``torch.profiler`` profile is active in the process, or while
  ``enabled(True)`` holds. Off, a span is one flag check. On, it enters
  ``record_function("cultionet." + name)``, so the range sits on the
  profile's timeline, and records (span id, parent id, request id, name,
  start ns, end ns) on the profiler's host clock (``time.time_ns``). A
  span opened with no span open is a root: it starts a request id that
  the spans inside it share, and it records how ``counters()`` moved while
  it was open. ``spans()``, ``totals()`` and ``reset()`` read and clear the
  records; past ``MAX_RECORDS`` records are dropped and counted, and
  ``totals()`` stays exact.
- ``COUNTS``: the copies between host and card of the data, predict and
  serve paths (``h2d_bytes``, ``d2h_bytes``, and ``blocking_copies``, those
  made with ``non_blocking=False``, each of which makes the host wait for
  the stream), always on; ``to_device`` and ``to_host`` copy and count.
  ``graph_captures`` and ``graph_replays`` count the train step's CUDA
  graph captures and replays (``train/graphed.py``, ``add_count``).
  ``utae_date_images`` and ``utae_pad_images`` count the date images of
  the dated batches the loaders deliver and the padding among them
  (``data/batch.py::count_date_images``). ``counters()`` adds every
  kernel's launch count (``ops/flags.py::launch_tables``), so a root
  span's counts hold each kernel's launches too.
- ``profile_trace(dir)``: profiles a block, writes the Chrome trace
  (``trace.json``) and the spans' totals with the card's idle time under
  each (``spans.json``, from ``idle_by_span``).
"""

import contextlib
import itertools
import json
import threading
import time
import typing as T
from pathlib import Path

import torch

from ..ops import flags

PREFIX = "cultionet."
MAX_RECORDS = 200_000
COUNTS: T.Dict[str, int] = {
    "h2d_bytes": 0, "d2h_bytes": 0, "blocking_copies": 0,
    "graph_captures": 0, "graph_replays": 0,
    "utae_date_images": 0, "utae_pad_images": 0,
}

_autograd_profiler = torch.autograd.profiler
_lock = threading.Lock()


class _Recorder:
    """The records and totals of the spans closed since the last reset,
    and each thread's stack of open spans."""

    def __init__(self):
        self.on = False
        self.ids = itertools.count(1)
        self.requests = itertools.count(1)
        self.local = threading.local()
        self.reset()

    def reset(self) -> None:
        self.records: T.List[dict] = []
        self.dropped = 0
        self.totals: T.Dict[str, dict] = {}

    def stack(self) -> T.List["_Span"]:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


_RECORDER = _Recorder()


class _Off:
    """The span of tracing off: enters and leaves nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "join", "range", "id", "parent", "request", "start",
                 "child_ns", "counts0")

    def __init__(self, name: str, join: bool):
        self.name = name
        self.join = join
        self.range = None

    def __enter__(self) -> None:
        stack = _RECORDER.stack()
        if self.join and stack and stack[-1].name == self.name:
            return
        parent = stack[-1] if stack else None
        self.id = next(_RECORDER.ids)
        self.parent = parent.id if parent else None
        self.request = parent.request if parent else next(_RECORDER.requests)
        self.counts0 = None if parent else counters()
        self.child_ns = 0
        stack.append(self)
        self.range = torch.profiler.record_function(PREFIX + self.name)
        self.start = time.time_ns()
        self.range.__enter__()

    def __exit__(self, *exc) -> bool:
        if self.range is None:
            return False
        self.range.__exit__(*exc)
        end = time.time_ns()
        stack = _RECORDER.stack()
        stack.pop()
        duration = end - self.start
        if stack:
            stack[-1].child_ns += duration
        record = {
            "id": self.id, "parent": self.parent, "request": self.request,
            "name": self.name, "start_ns": self.start, "end_ns": end,
        }
        if self.counts0 is not None:
            record["counts"] = {k: v - self.counts0[k] for k, v in counters().items()}
        with _lock:
            total = _RECORDER.totals.setdefault(
                self.name, {"count": 0, "total_ns": 0, "self_ns": 0, "counts": {}}
            )
            total["count"] += 1
            total["total_ns"] += duration
            total["self_ns"] += duration - self.child_ns
            for k, v in record.get("counts", {}).items():
                total["counts"][k] = total["counts"].get(k, 0) + v
            if len(_RECORDER.records) < MAX_RECORDS:
                _RECORDER.records.append(record)
            else:
                _RECORDER.dropped += 1
        return False


def enabled(on: T.Optional[bool] = None) -> bool:
    """With ``on``, turn the module's own switch on or off; whether spans
    record now (the switch, or an active profiler)."""
    if on is not None:
        _RECORDER.on = bool(on)
    return _RECORDER.on or _autograd_profiler._is_profiler_enabled


def span(name: str, join: bool = False):
    """A context manager around one layer's part of a unit of work. With
    ``join``, inside an open span of the same name it adds nothing (a step
    that a wrapper already opened)."""
    if not (_RECORDER.on or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, join)


def spans() -> T.List[dict]:
    """The kept records, in the order they closed."""
    with _lock:
        return list(_RECORDER.records)


def dropped() -> int:
    """Records dropped past ``MAX_RECORDS`` since the last reset."""
    return _RECORDER.dropped


def totals() -> T.Dict[str, dict]:
    """Per span name: ``count``, ``total_ns``, ``self_ns`` (the duration
    less the part its child spans cover) and, summed over the root spans
    of that name, ``counts``: how each of ``counters()`` moved inside
    them."""
    with _lock:
        return {
            name: dict(t, counts=dict(t["counts"]))
            for name, t in _RECORDER.totals.items()
        }


def reset() -> None:
    """Clear the records, the totals and the dropped count."""
    with _lock:
        _RECORDER.reset()


def _crosses(src: torch.Tensor, dst: torch.Tensor) -> bool:
    """Whether a copy from ``src`` to ``dst`` moved between host and card."""
    return src.device != dst.device and "cpu" in (src.device.type, dst.device.type)


def _count(key: str, out: torch.Tensor, non_blocking: bool) -> None:
    with _lock:
        COUNTS[key] += out.numel() * out.element_size()
        if not non_blocking:
            COUNTS["blocking_copies"] += 1


def add_count(key: str, n: int = 1) -> None:
    """Add ``n`` to ``COUNTS[key]``."""
    with _lock:
        COUNTS[key] += n


def to_device(value: torch.Tensor, device, non_blocking: bool = False) -> torch.Tensor:
    """``value.to(device)``, counted where it copies from the host."""
    out = value.to(device, non_blocking=non_blocking)
    if _crosses(value, out):
        _count("h2d_bytes", out, non_blocking)
    return out


def to_host(value: torch.Tensor) -> torch.Tensor:
    """``value.cpu()``, counted where it copies from the card."""
    out = value.cpu()
    if _crosses(value, out):
        _count("d2h_bytes", out, False)
    return out


def counters() -> T.Dict[str, int]:
    """``COUNTS`` and the kernel launch counters, by name."""
    out = dict(COUNTS)
    for table in flags.launch_tables():
        out.update(table)
    return out


def idle_by_span(prof) -> T.Dict[str, float]:
    """The card's idle ns in a finished profile, by the innermost
    ``cultionet.`` span open at the middle of each gap ("between spans"
    where none is): the gaps between the union of its kernel and copy
    intervals."""
    events = list(prof.profiler.kineto_results.events())
    # Host ranges are mirrored on the device timeline under their host
    # names: not device work.
    host = [e for e in events if "CUDA" not in str(e.device_type())]
    host_names = {e.name() for e in host}
    device = sorted(
        (e.start_ns(), e.start_ns() + e.duration_ns())
        for e in events
        if "CUDA" in str(e.device_type()) and e.name() not in host_names
    )
    ranges = [
        (e.start_ns(), e.start_ns() + e.duration_ns(), e.name()[len(PREFIX):])
        for e in host
        if e.name().startswith(PREFIX)
    ]
    merged: T.List[T.List[int]] = []
    for start, end in device:
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    idle: T.Dict[str, float] = {}
    for (_, gap_start), (gap_end, _) in zip(merged, merged[1:]):
        middle = (gap_start + gap_end) / 2
        open_ranges = [r for r in ranges if r[0] <= middle <= r[1]]
        # The innermost open range: the latest to start.
        label = max(open_ranges)[2] if open_ranges else "between spans"
        idle[label] = idle.get(label, 0.0) + (gap_end - gap_start)
    return idle


def _moved(before: T.Dict[str, dict], after: T.Dict[str, dict]) -> T.Dict[str, dict]:
    """The totals of the spans closed between two ``totals()``."""
    out = {}
    for name, t in after.items():
        b = before.get(name, {"count": 0, "total_ns": 0, "self_ns": 0})
        if t["count"] > b["count"]:
            out[name] = {k: t[k] - b[k] for k in ("count", "total_ns", "self_ns")}
    return out


@contextlib.contextmanager
def profile_trace(log_dir: T.Union[str, Path]):
    """Profile the block with ``torch.profiler`` (host activity, and the
    card's kernels where CUDA is available) and write to ``log_dir`` the
    Chrome trace, ``trace.json`` (viewable in Perfetto or TensorBoard),
    and ``spans.json``: per span name closed in the block, its count, total
    and self ms and the card's idle ms under it (``idle_by_span``); the
    counters' movement over the block; records dropped."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    before, counts0, dropped0 = totals(), counters(), dropped()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    moved = _moved(before, totals())
    idle = idle_by_span(prof)
    summary = {
        "spans": {
            name: {
                "count": t["count"],
                "total_ms": t["total_ns"] / 1e6,
                "self_ms": t["self_ns"] / 1e6,
                "idle_ms": idle.get(name, 0.0) / 1e6,
            }
            for name, t in sorted(moved.items())
        },
        "idle_between_spans_ms": idle.get("between spans", 0.0) / 1e6,
        "counters": {k: v - counts0.get(k, 0) for k, v in counters().items()},
        "dropped": dropped() - dropped0,
    }
    (log_dir / "spans.json").write_text(json.dumps(summary, indent=2))
    prof.export_chrome_trace(str(log_dir / "trace.json"))
