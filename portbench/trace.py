"""The traced run's profiler: short spans of the measured window under
``torch.profiler``, and what is read from them.

``Tracer.step()`` is called once per iteration of the window's loop. Every
``every`` iterations it synchronizes the card and opens a span of ``span``
iterations under the profiler (host ranges and device activity); at the
span's end it synchronizes again, reads the spans' device intervals, kernel
times by name, the benchmark's own host ranges (``layer``), and the
program's launch counters, and drops the profile, so the trace stays in
memory only for one span; ``device_seconds`` and ``breakdown`` give what
the metrics and the result line read.
"""

import contextlib
import re
import time
import typing as T

import torch

# The host ranges the drivers open around the calls into each layer.
RANGE_PREFIX = "portbench."


@contextlib.contextmanager
def layer(name: str) -> T.Iterator[None]:
    """A host range around a call into one layer of the program."""
    with torch.profiler.record_function(RANGE_PREFIX + name):
        yield


def launch_counts() -> T.Dict[str, int]:
    """The program's kernel launch counters, by kernel."""
    from cultionet_tpu_torch.ops import na_block_cuda, natten_cuda, temporal_cuda

    counts: T.Dict[str, int] = {}
    for table in (natten_cuda.LAUNCHES, temporal_cuda.LAUNCHES, na_block_cuda.LAUNCHES):
        counts.update(table)
    return counts


def _union_seconds(intervals: T.List[T.Tuple[int, int]]) -> T.Tuple[float, list]:
    """Total covered ns as seconds, and the merged intervals."""
    merged: T.List[T.List[int]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return sum(e - s for s, e in merged) / 1e9, merged


class Tracer:
    def __init__(self, enabled: bool, span: int, every: int, device: torch.device):
        self.enabled = enabled
        self.span = span
        self.every = every
        self.device = device
        self.iteration = 0
        self.prof = None
        self.opened_at = 0
        self.window_s = 0.0
        self.busy_s = 0.0
        self.spans = 0
        self.iterations = 0  # loop iterations inside the spans
        self.kernel_s: T.Dict[str, float] = {}
        self.launches: T.Dict[str, int] = {}
        self.gaps: T.List[T.Tuple[str, float]] = []
        self._counts0: T.Dict[str, int] = {}
        self._wall0 = 0.0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self) -> None:
        if not self.enabled:
            return
        self.iteration += 1
        if self.prof is None and self.iteration % self.every == 0:
            self._open()
        elif self.prof is not None and self.iteration - self.opened_at >= self.span:
            self._close()

    def close(self) -> None:
        if self.prof is not None:
            self._close()

    def _open(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._sync()
        self._counts0 = launch_counts()
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        self.opened_at = self.iteration
        self._wall0 = time.perf_counter()

    def _close(self) -> None:
        self._sync()
        wall = time.perf_counter() - self._wall0
        self.prof.__exit__(None, None, None)
        counts = launch_counts()
        for name, value in counts.items():
            self.launches[name] = self.launches.get(name, 0) + value - self._counts0.get(name, 0)
        device, ranges = [], []
        events = list(self.prof.profiler.kineto_results.events())
        # Host ranges (record_function, the optimizer's) are mirrored on
        # the device timeline under their host names: not device work.
        host_names = {e.name() for e in events if "CUDA" not in str(e.device_type())}
        for e in events:
            start, end = e.start_ns(), e.start_ns() + e.duration_ns()
            if "CUDA" in str(e.device_type()) and e.name() not in host_names:
                name = e.name()
                device.append((start, end))
                self.kernel_s[name] = self.kernel_s.get(name, 0.0) + e.duration_ns() / 1e9
            elif "CUDA" not in str(e.device_type()) and e.name().startswith(RANGE_PREFIX):
                ranges.append((start, end, e.name()[len(RANGE_PREFIX):]))
        self.prof = None
        self.spans += 1
        self.iterations += self.iteration - self.opened_at
        self.window_s += wall
        if not device:
            return
        busy, merged = _union_seconds(device)
        self.busy_s += busy
        for (_, gap_start), (gap_end, _) in zip(merged, merged[1:]):
            middle = (gap_start + gap_end) / 2
            open_ranges = [r for r in ranges if r[0] <= middle <= r[1]]
            # The innermost open range: the latest to start.
            label = max(open_ranges)[2] if open_ranges else "between ranges"
            self.gaps.append((label, (gap_end - gap_start) / 1e9))

    def device_seconds(self, patterns: T.Sequence[str]) -> float:
        """Device seconds of the kernels whose names match any pattern."""
        regex = re.compile("|".join(patterns))
        return sum(s for name, s in self.kernel_s.items() if regex.search(name))

    def breakdown(self) -> T.Dict[str, list]:
        """The kernels with the most device seconds, and the device's idle
        seconds summed by the host range open in each gap."""
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        idle: T.Dict[str, float] = {}
        for label, seconds in self.gaps:
            idle[label] = idle.get(label, 0.0) + seconds
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        return {
            "device_ops": [[name[:120], s] for name, s in ops],
            "idle_gaps": [[label, s] for label, s in gaps],
        }
