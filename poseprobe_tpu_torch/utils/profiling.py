"""Profiling and debugging helpers.

Port of `poseprobe_tpu/utils/profiling.py`:

* `trace(logdir)`: a context manager that records a `torch.profiler` trace
  (host and, on a card, device activity) and writes it to `logdir` as a
  Chrome trace;
* `RaysPerSecond`: a sliding-window throughput meter;
* `nan_debug(fn)`: in place of the reference's `checkify_nan_debug`, runs
  `fn` under `torch.autograd.detect_anomaly` (a backward that produces NaN
  raises, naming the forward op) and raises `FloatingPointError` when a
  tensor it returns holds a non-finite value.
"""
from __future__ import annotations

import contextlib
import functools
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed code and write ``trace.json`` into `logdir`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class RaysPerSecond:
    """Sliding-window rays/s counter."""

    def __init__(self, window: int = 50):
        self.window = window
        self._events: list[tuple[float, int]] = []

    def update(self, n_rays: int) -> float:
        now = time.perf_counter()
        self._events.append((now, n_rays))
        if len(self._events) > self.window:
            self._events.pop(0)
        if len(self._events) < 2:
            return 0.0
        dt = self._events[-1][0] - self._events[0][0]
        total = sum(n for _, n in self._events[1:])
        return total / max(dt, 1e-9)


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _tensors(v)


def nan_debug(fn):
    """`fn` wrapped to run under `torch.autograd.detect_anomaly` and to raise
    `FloatingPointError` if a tensor in its output (nested in dicts, lists or
    tuples) is not finite."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with torch.autograd.detect_anomaly():
            out = fn(*args, **kwargs)
        for t in _tensors(out):
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                raise FloatingPointError(f"{getattr(fn, '__name__', fn)} returned a non-finite value "
                                         f"(a tensor of shape {tuple(t.shape)})")
        return out
    return wrapped
