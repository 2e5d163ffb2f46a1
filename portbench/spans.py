"""The program's spans on the device trace's clock: device time and device-idle
gaps put down to the program's layers.

The port marks its layers with `poseprobe.<layer>.<part>` spans
(`poseprobe_tpu_torch/utils/profiling.span`: a `record_function` while a
profiler runs). `record(unit, n)` profiles `n` calls of a unit under
`torch.profiler`, after a discarded warm-up call, inside one host span, and
profiles again a window that lost device events (`trace.py`'s check). Then
`attribute` (`profile` does both) gives

- each device event to the innermost `poseprobe.*` span that holds the host op
  that launched it (the profiler links a kernel, copy or memset to that op by
  its correlation id). An op that autograd's engine runs (inside an
  `autograd::engine::evaluate_function` op) goes to the span of the forward op
  with the same sequence number on the forward thread, so a backward counts
  with its forward. An op in no span goes to `(outside)`; device time that no
  op claims, to `(unlinked)`;
- each device-idle gap (`trace.union_length`) to the innermost span open on
  the host at the gap's start, or to `(no program span)`.

A replayed CUDA graph runs no host code, so its device time cannot be split by
host spans: the training cells are split from eager steps of the same cell
(`tr.step()`), which launch the kernels the capture recorded; the replayed
steps' idle gaps are named by the host loop's spans (`poseprobe.host.replay`,
`.set_step`) in a profiled replay unit of the cell. `of(ctx)` is the readers'
entry: once per run it builds the cell's window again by its own driver (the
window that was measured is closed before the readers run), profiles the
cell's replay unit (training) and its span unit (`SPAN_STEPS` eager steps from
the cell's start step, or a render band), prints each span's device ms and
idle ms a unit to standard error and returns a `Spans`. Where the program has
no spans it returns None.
"""
from __future__ import annotations

import dataclasses
import gc
import sys

import torch

from . import manifest, trace

PREFIX = "poseprobe."
WINDOW = "portbench.span_window"
ENGINE = "autograd::engine::evaluate_function"
OUTSIDE, UNLINKED, NO_SPAN = "(outside)", "(unlinked)", "(no program span)"
# eager steps in a training cell's span unit: on the card a unit of 10 (~120k host ops, ~29k
# kernels under the profiler) lost device events in most windows; every step of a unit launches
# the same kernels, so 2 x 2 steps split it as well
SPAN_STEPS = 2


@dataclasses.dataclass(frozen=True)
class Op:
    """A host op or span of the trace: times in us, `kernels` the (name,
    device seconds) of the device events the profiler linked to it."""
    name: str
    thread: int
    start: float
    end: float
    seq: int = -1
    fwd_thread: int = 0
    kernels: tuple = ()


@dataclasses.dataclass
class Spans:
    per: str                        # "step" or "band"
    units: int                      # steps or bands profiled
    total_ms: float                 # device ms a unit
    device_ms: dict                 # innermost span (or OUTSIDE, UNLINKED) -> device ms a unit
    idle_ms: dict                   # innermost open span (or NO_SPAN) -> device-idle ms a unit
    values: dict                    # program counters read over the stretch
    replay_idle_ms: dict = dataclasses.field(default_factory=dict)   # the same, a replayed step


def _innermost(items, queries) -> list:
    """For each query (thread, start, end), the innermost item (thread, start,
    end, payload) on the same thread whose interval holds it, or None. Items
    on one thread nest, as host spans do."""
    out = [None] * len(queries)
    by_thread: dict = {}
    for it in items:
        by_thread.setdefault(it[0], []).append((it[1], 0, -it[2], it))
    for i, q in enumerate(queries):
        by_thread.setdefault(q[0], []).append((q[1], 1, -q[2], i))
    for events in by_thread.values():
        stack: list = []
        for start, kind, neg_end, x in sorted(events, key=lambda e: e[:3]):
            while stack and stack[-1][2] < start:
                stack.pop()
            if kind == 0:
                stack.append(x)
                continue
            for it in reversed(stack):
                if it[2] >= -neg_end:
                    out[x] = it
                    break
    return out


def attribute(ops, device, lo: float, hi: float) -> dict:
    """Device seconds by span (`device_s`; by span and event name, `by_kernel`)
    and idle seconds by span (`idle_s`) over the window [lo, hi] (us). `ops`:
    `Op`s, the spans among them; `device`: (name, start, end) of the device
    events in the window."""
    spans = [(o.thread, o.start, o.end, o.name) for o in ops if o.name.startswith(PREFIX)]
    engine = [(o.thread, o.start, o.end, o) for o in ops if o.name.startswith(ENGINE)]
    work = [o for o in ops if not o.name.startswith(PREFIX)]
    span_of = [it and it[3] for it in _innermost(spans, [(o.thread, o.start, o.end) for o in work])]
    engine_of = [it and it[3] for it in _innermost(engine, [(o.thread, o.start, o.end) for o in work])]
    # (thread, sequence number) -> span of the forward op that made the autograd node: ops record
    # the number the next node will take, so the last op to record it made the node
    forward = {}
    for o, s in sorted(zip(work, span_of), key=lambda x: x[0].start):
        if o.seq >= 0 and not o.name.startswith(ENGINE):
            forward[(o.thread, o.seq)] = s
    of_name: dict = {}                             # device seconds by event name
    for n, start, end in device:
        of_name[n] = of_name.get(n, 0.0) + (end - start) / 1e6
    by_kernel: dict = {}                           # (span, event name) -> device seconds
    linked: dict = {}
    for o, s, e in zip(work, span_of, engine_of):
        mine = [(n, d) for n, d in o.kernels if n in of_name]
        if not mine:
            continue
        if e is not None and e.seq >= 0 and (e.fwd_thread, e.seq) in forward:
            s = forward[(e.fwd_thread, e.seq)]
        for n, d in mine:
            by_kernel[(s or OUTSIDE, n)] = by_kernel.get((s or OUTSIDE, n), 0.0) + d
            linked[n] = linked.get(n, 0.0) + d
    for n, t in of_name.items():
        by_kernel[(UNLINKED, n)] = t - linked.get(n, 0.0)
    device_s: dict = {UNLINKED: 0.0}
    for (key, _), v in by_kernel.items():
        device_s[key] = device_s.get(key, 0.0) + v
    total = sum(of_name.values())

    # a gap goes to the innermost span open at its start, on whichever thread
    busy, gaps = trace.union_length([(s, e) for _, s, e in device], lo, hi)
    threads = sorted({sp[0] for sp in spans})
    found = _innermost(spans, [(t, g[0], g[0]) for g in gaps for t in threads])
    idle_s: dict = {}
    for i, g in enumerate(gaps):
        held = [f for f in found[i * len(threads):(i + 1) * len(threads)] if f is not None]
        key = max(held, key=lambda f: f[1])[3] if held else NO_SPAN
        idle_s[key] = idle_s.get(key, 0.0) + (g[1] - g[0]) / 1e6
    return {"device_s": device_s, "by_kernel": by_kernel, "idle_s": idle_s, "total_s": total,
            "busy_s": busy / 1e6}


def _events(prof) -> tuple:
    """(host ops and spans, device events (name, start, end), window start, window
    end) of the profiled cycle, whose one host span `WINDOW` holds the units,
    read from the profiler's raw events (its linked correlation ids tie a
    device event to the host op that launched it; building `prof.events()` for
    an eager stretch takes tens of seconds); times in us from the window's
    start. Nothing is clipped to the window, whose edges the device clock may
    cross by a few us: the cycle holds only the units and the profiler's own
    step marks."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    raw = prof.profiler.kineto_results.events()
    window = [e for e in raw if e.name() == WINDOW and e.device_type() == cpu]
    if len(window) != 1:
        raise RuntimeError(f"the trace holds {len(window)} host spans named {WINDOW}")
    base = window[0].start_ns()                 # times from the window's start: whole ns, exact
    lo, hi = 0.0, (window[0].end_ns() - base) / 1e3
    device, launched = [], {}
    for e in raw:
        name = e.name()
        if (e.device_type() != cuda or e.is_user_annotation() or name == WINDOW
                or name.startswith("ProfilerStep")):              # as `trace._device_events` leaves out
            continue
        start, end = (e.start_ns() - base) / 1e3, (e.end_ns() - base) / 1e3
        if end > start:
            device.append((name, start, end))
            launched.setdefault(e.linked_correlation_id(), []).append((name, (e.end_ns() - e.start_ns()) / 1e9))
    ops = []
    for e in raw:
        if e.device_type() != cpu or e.is_async() or e.linked_correlation_id() != 0 or e.name() == WINDOW:
            continue
        corr = e.correlation_id()                # a launch is one op's: the first to carry its id
        ops.append(Op(e.name(), e.start_thread_id(), (e.start_ns() - base) / 1e3, (e.end_ns() - base) / 1e3,
                      e.sequence_nr(), e.fwd_thread_id(), tuple(launched.pop(corr, ())) if corr else ()))
    return ops, device, lo, hi


def record(unit, n: int, tries: int = 10) -> tuple:
    """(host ops and spans, device events, window start, window end) of `n`
    calls of `unit` (each runs one unit and synchronises), profiled after a
    discarded warm-up call; times in us. A window in which the profiler lost
    device events (none, or a name whose count is not a multiple of `n`) is
    profiled again, at most `tries` times."""
    from torch.profiler import ProfilerActivity, profile as profiler, record_function, schedule
    lost = []
    for _ in range(tries):
        with profiler(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                      schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            unit()
            prof.step()
            with record_function(WINDOW):
                for _ in range(n):
                    unit()
            prof.step()
        ops, device, lo, hi = _events(prof)
        counts: dict = {}
        for name, _, _ in device:
            counts[name] = counts.get(name, 0) + 1
        if device and all(c % n == 0 for c in counts.values()):
            if lost:
                print(f"spans: torch.profiler lost device events in {len(lost)} window(s) before this one: "
                      + "; ".join(lost), file=sys.stderr)
            return ops, device, lo, hi
        lost.append(f"{len(counts)} names, {sum(c % n != 0 for c in counts.values())} uneven"
                    if device else "no device event")
    raise RuntimeError(f"torch.profiler lost device events in {tries} span windows: " + "; ".join(lost))


def profile(unit, n: int) -> dict:
    """`attribute` over `n` calls of `unit` (`record`)."""
    return attribute(*record(unit, n))


def _train_unit(window, fills: list):
    """`SPAN_STEPS` eager steps from the cell's start step; the mask cache's
    fill of each step goes to `fills`."""
    def unit():
        window.tr.global_step = window.start
        for _ in range(SPAN_STEPS):
            m = window.tr.step()
            if "maskcache_fill" in m:
                fills.append(m["maskcache_fill"])
        if window.run.device.type == "cuda":
            torch.cuda.synchronize(window.run.device)
    return unit


_LAST: list = [None, None]          # the context read last and its Spans


def of(ctx):
    """The cell's `Spans`, profiled once per run (None where the program has no spans)."""
    if _LAST[0] is ctx:
        return _LAST[1]
    _LAST[:] = [ctx, _measure(ctx)]
    return _LAST[1]


def _measure(ctx):
    from poseprobe_tpu_torch.utils import profiling
    if not hasattr(profiling, "span"):
        return None
    run = dataclasses.replace(ctx.run, spans={}, values={}, work={})
    window = manifest.driver(run.cell["driver"]).setup(run)
    n, fills, replay_idle = run.cell["trace_units"], [], {}
    try:
        if run.cell["driver"] == "train":
            per, units = "step", n * SPAN_STEPS
            # the replays first, from the state the traced stretch profiles
            steps = n * window.trace_steps
            replay_idle = {k: 1e3 * v / steps for k, v in profile(window.trace_unit, n)["idle_s"].items()}
            found = profile(_train_unit(window, fills), n)
        else:
            per, units = "band", n
            found = profile(window.trace_unit, n)
        values = {}
        if fills:
            values["maskcache_fill"] = float(torch.stack(fills[-units:]).float().mean())
    finally:
        window.close()
        del window
        gc.collect()
        if run.device.type == "cuda":
            torch.cuda.empty_cache()
    out = Spans(per=per, units=units, total_ms=1e3 * found["total_s"] / units,
                device_ms={k: 1e3 * v / units for k, v in found["device_s"].items()},
                idle_ms={k: 1e3 * v / units for k, v in found["idle_s"].items()}, values=values,
                replay_idle_ms=replay_idle)
    for k, v in sorted(out.device_ms.items(), key=lambda kv: -kv[1]):
        print(f"span {k}: {v:.4f} device ms a {per}", file=sys.stderr)
    for k, v in sorted(out.idle_ms.items(), key=lambda kv: -kv[1]):
        print(f"span {k}: {v:.4f} device-idle ms a {per}", file=sys.stderr)
    for k, v in sorted(out.replay_idle_ms.items(), key=lambda kv: -kv[1]):
        print(f"span {k}: {v:.4f} device-idle ms a replayed step", file=sys.stderr)
    print(f"spans: {out.total_ms:.4f} device ms a {per} over {units} {per}s", file=sys.stderr)
    return out


def device_ms(ctx, keep) -> float | None:
    """Device ms a unit of the spans whose name `keep` accepts; None where the
    program has no spans or none of them ran."""
    sp = of(ctx)
    if sp is None:
        return None
    hits = [v for k, v in sp.device_ms.items() if k.startswith(PREFIX) and keep(k)]
    return sum(hits) if hits else None
