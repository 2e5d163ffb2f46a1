"""The traced stretch of a run: device time by kernel name, the device's busy
and idle time on the stretch's own timeline, and the longest idle gaps named
by the host op that was running.

`traced(unit, n)` profiles `n` units under `torch.profiler` after a discarded
warm-up unit (the trace has been seen to drop the first kernels launched
after the profiler starts), inside one host span named `WINDOW`. A window in
which the profiler lost device events (none, or a kernel whose count is not
the same in every unit) is profiled again, at most `tries` times; then the
run fails. Device intervals are never summed as they are: busy time is the
length of their union, clipped to the span.
"""
from __future__ import annotations

import dataclasses

import torch

WINDOW = "portbench.traced_window"


@dataclasses.dataclass
class Trace:
    units: int                      # units in the traced window
    window_s: float                 # the traced span's wall length
    busy_s: float                   # the union of device intervals inside it
    by_name: dict                   # kernel, copy or memset name -> device seconds in the window
    device_ops: list                # [[name, seconds]], the ten longest by total
    idle_gaps: list                 # [[host op, seconds]], the ten longest gaps


def union_length(intervals, lo: float, hi: float) -> tuple[float, list]:
    """(length of the union of [start, end) intervals clipped to [lo, hi],
    the gaps [(start, end)] the union leaves in [lo, hi])."""
    busy, gaps, cur = 0.0, [], lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if hi > cur:
        gaps.append((cur, hi))
    return busy, gaps


def name_gap(gap, host_ops) -> str:
    """The innermost host op whose interval holds the gap's start."""
    best, best_start = "host (no op)", None
    for name, s, e in host_ops:
        if s <= gap[0] < e and (best_start is None or s >= best_start):
            best, best_start = name, s
    return best


def _device_events(prof):
    """Kernels, copies and memsets: the device's own events, without the host
    spans the profiler also draws on the device's timeline."""
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and e.name != WINDOW
            and not e.name.startswith("ProfilerStep") and e.time_range.end > e.time_range.start]


def traced(unit, n: int, tries: int = 5) -> Trace:
    """Profile `n` calls of `unit` (each runs one unit and synchronises)."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule
    lost = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            unit()
            prof.step()
            with record_function(WINDOW):
                for _ in range(n):
                    unit()
            prof.step()
        events = _device_events(prof)
        counts: dict = {}
        for e in events:
            counts[e.name] = counts.get(e.name, 0) + 1
        if events and all(c % n == 0 for c in counts.values()):
            return _reduce(prof, events, n)
        odd = [f"{k[:60]} x{c}" for k, c in counts.items() if c % n]
        lost.append((", ".join(odd[:6]) + f" ({len(odd)} of {len(counts)} names)") if events else "no device event")
    raise RuntimeError(f"torch.profiler lost device events in {tries} windows: " + "; ".join(lost))


def _reduce(prof, events, n: int) -> Trace:
    cpu = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    span = [e for e in cpu if e.name == WINDOW]
    if len(span) != 1:
        raise RuntimeError(f"the trace holds {len(span)} spans named {WINDOW}")
    lo, hi = span[0].time_range.start, span[0].time_range.end
    inside = [e for e in events if e.time_range.start >= lo and e.time_range.end <= hi]
    busy_us, gaps = union_length([(e.time_range.start, e.time_range.end) for e in inside], lo, hi)
    by_name: dict = {}
    for e in inside:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e6
    host = [(e.name, e.time_range.start, e.time_range.end) for e in cpu if e.name != WINDOW]
    gaps = sorted(gaps, key=lambda g: g[1] - g[0], reverse=True)[:10]
    return Trace(units=n, window_s=(hi - lo) / 1e6, busy_s=busy_us / 1e6, by_name=by_name,
                 device_ops=[[k, v] for k, v in sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:10]],
                 idle_gaps=[[name_gap(g, host), (g[1] - g[0]) / 1e6] for g in gaps])
