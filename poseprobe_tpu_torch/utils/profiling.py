"""Profiling and debugging helpers.

Port of `poseprobe_tpu/utils/profiling.py`:

* `span(name)`: a host span at one of the program's layer boundaries
  (`poseprobe.<layer>.<part>`), a `torch.profiler.record_function` while a
  profiler is running and a shared no-op context otherwise, so the spans
  cost ~1 us each when nothing traces. Under a profiler they land in its
  trace beside the device events, on the same clock; the device work
  launched inside a span (and, through autograd's sequence numbers, its
  backward) can be put down to it;
* `nan_debug(fn)`: in place of the reference's `checkify_nan_debug`, runs
  `fn` under `torch.autograd.detect_anomaly` (a backward that produces NaN
  raises, naming the forward op) and raises `FloatingPointError` when a
  tensor it returns holds a non-finite value.
"""
from __future__ import annotations

import contextlib
import functools

import torch

NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """`torch.profiler.record_function(name)` while a profiler is running,
    else the shared no-op context `NO_SPAN`."""
    return torch.profiler.record_function(name) if torch.autograd._profiler_enabled() else NO_SPAN


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
