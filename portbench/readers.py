"""Arithmetic shared by the per-layer metrics' readers (`metrics/<name>.py`).
A reader returns None where it finds nothing to read; it never returns 0 for
a share of a roofline or of a peak."""
from __future__ import annotations

from .counts import peaks, work as work_mod

# the port's hand-written kernels, by the names their launches carry in the trace
TRUNK = ("trunk_",)
GRID = ("trilinear_", "scatter_rows")
HAND_WRITTEN = TRUNK + GRID + ("composite_", "materialize", "transpose", "rows_to_channels", "channels_to_rows")


def device_s(trace, names) -> float:
    return sum(s for n, s in trace.by_name.items() if any(k in n for k in names))


def calls(ctx) -> tuple[list, list]:
    """The traced window's trunk calls and grid lookups, counted from the configuration."""
    w = ctx.trace_work
    if "step" in w:
        return w["step"]["trunk_calls"] * w["steps"], w["step"]["lookups"] * w["steps"]
    return w["band"]["trunk_calls"] * w["bands"], w["band"]["lookups"] * w["bands"]


def trunk_roofline_pct(ctx):
    t = device_s(ctx.trace, TRUNK)
    trunk_calls, _ = calls(ctx)
    if t <= 0 or not trunk_calls:
        return None
    sm = ctx.run.config["experiment"]["scene_model"]
    least = 0.0
    for n, grad in trunk_calls:
        least += peaks.least_seconds(*work_mod.trunk_call_cost(sm, n, False))
        if grad:
            least += peaks.least_seconds(*work_mod.trunk_call_cost(sm, n, True))
    return 100.0 * least / t


def grid_roofline_pct(ctx):
    t = device_s(ctx.trace, GRID)
    _, lookups = calls(ctx)
    if t <= 0 or not lookups:
        return None
    nbytes = sum(work_mod.lookup_cost(n, c, g, False) + (work_mod.lookup_cost(n, c, g, True) if b else 0.0)
                 for n, c, g, b in lookups)
    return 100.0 * nbytes / peaks.HBM_BYTES / t


def idle_pct(ctx):
    tr = ctx.trace
    return None if tr is None or tr.window_s <= 0 else 100.0 * (1.0 - tr.busy_s / tr.window_s)


def mfu_pct(ctx):
    flops = ctx.run.work.get("flops", 0.0) * ctx.unprofiled_units
    return None if flops <= 0 or ctx.unprofiled_s <= 0 else 100.0 * flops / ctx.unprofiled_s / peaks.BF16_FLOPS


def plain_ops_ms_per_step(ctx):
    steps = ctx.trace_work.get("steps")
    if not steps:
        return None
    other = sum(s for n, s in ctx.trace.by_name.items() if not any(k in n for k in HAND_WRITTEN))
    return 1e3 * other / steps
