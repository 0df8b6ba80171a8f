"""Readings the per-layer metrics share. Each returns None where the run
has nothing to read (no device activity, no launches, no units)."""

import typing as T

from portbench.roofline import BF16_FLOPS


def idle_percent(ctx) -> T.Optional[float]:
    """100 x (1 - device-busy seconds / span seconds), over the spans."""
    t = ctx.tracer
    if t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def host_ms_per_unit(ctx, key: str) -> T.Optional[float]:
    """Host milliseconds of ``ctx.host_s[key]`` per loop iteration."""
    if not ctx.units or key not in ctx.host_s:
        return None
    return 1e3 * ctx.host_s[key] / ctx.units


def mfu_percent(ctx) -> T.Optional[float]:
    """The model's FLOPs done per second over the window's untraced part,
    as a share of the bf16 dense peak."""
    if ctx.counts is None or ctx.device.type != "cuda":
        return None
    t = ctx.tracer
    units = ctx.units - t.iterations
    seconds = ctx.window_s - t.window_s
    if units <= 0 or seconds <= 0:
        return None
    per_unit = ctx.counts.flops() * ctx.extra.get("calls_per_unit", 1)
    return 100.0 * per_unit * units / seconds / BF16_FLOPS


def roofline_percent(
    ctx, patterns: T.Sequence[str], least_s_per_launch_cycle: float,
    launches: T.Sequence[str], sites: int,
) -> T.Optional[float]:
    """100 x the least time of the launches counted in the spans over the
    device time of the kernels matching ``patterns``. Each group of
    ``sites`` launches of the ``launches`` counters is one pass over the
    call sites, whose least time is ``least_s_per_launch_cycle``."""
    t = ctx.tracer
    count = sum(t.launches.get(name, 0) for name in launches)
    seconds = t.device_seconds(patterns)
    if count == 0 or seconds <= 0 or sites == 0:
        return None
    return 100.0 * (count / sites) * least_s_per_launch_cycle / seconds
