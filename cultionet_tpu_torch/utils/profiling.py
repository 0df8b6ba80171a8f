"""Profiling for the command line's ``--profiler DIR`` (the port's
counterpart of cultionet_tpu/utils/profiling.py::profile_trace, on
``torch.profiler``)."""

import contextlib
import typing as T
from pathlib import Path

import torch


@contextlib.contextmanager
def profile_trace(log_dir: T.Union[str, Path]):
    """Profile the block with ``torch.profiler`` (host activity, and the
    card's kernels where CUDA is available) and write the Chrome trace to
    ``log_dir/trace.json``, viewable in Perfetto or TensorBoard."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))
