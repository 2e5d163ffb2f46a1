"""CUDA-graph replay of the training step: the port's counterpart of the
reference's `lax.scan` superstep (`_train_scan`, `steps_scan`).

The reference runs the K steps between two host events as one XLA program.
Here one step of a cell (its phase flags, active views, mask-cache budget,
config and state shapes) is captured once in a `torch.cuda.CUDAGraph`, and a
replay launches all of the step's kernels from one host call. The step is
graph-safe (`SceneTrainer._step_body`): it reads and writes device tensors
at fixed addresses only (the params, Adam moments and counts, the step
counter, the seeded poses, the mask cache) and draws its random numbers
from the trainer's device generator, which is registered with the graph so
that every replay draws new numbers, the ones the same number of eager steps
would have drawn.

A graph is replayed only while every persistent tensor it captured is still
the trainer's (`StepGraph.holds`); a host event that rebinds one drops it.
The kernels' launch counters are Python counters, which a replay does not
run: a graph records the launches its capture made and adds them at each
replay (the trunk's by kernel instantiation too, the encoding's by kernel).
"""
from __future__ import annotations

import contextlib
import time

import torch

from ..ops import fused_composite, fused_mlp, grid, layout, pe

_COUNTERS = ((fused_mlp, "fwd_launches"), (fused_mlp, "bwd_launches"), (grid, "fwd_launches"),
             (grid, "bwd_launches"), (layout, "transpose2d_launches"),
             (layout, "transpose_slice_launches"), (layout, "materialize_launches"),
             (fused_composite, "fwd_launches"), (fused_composite, "bwd_launches"),
             (fused_composite, "fwd_chunked_launches"), (fused_composite, "bwd_chunked_launches"))


# the counters kept in dicts by kernel: the trunk's instantiations, then the encoding's kernels
_BY_KERNEL = (tuple((fused_mlp.launches, k) for k in fused_mlp.KERNEL_NAMES)
              + tuple((pe.launches, k) for k in pe.launches))


def _counts() -> list:
    """Every launch counter: the wrappers' integers, then those kept by kernel (`_BY_KERNEL`)."""
    return [getattr(mod, name) for mod, name in _COUNTERS] + [d[k] for d, k in _BY_KERNEL]


def _add_counts(values) -> None:
    for (mod, name), n in zip(_COUNTERS, values):
        setattr(mod, name, getattr(mod, name) + n)
    for (d, k), n in zip(_BY_KERNEL, values[len(_COUNTERS):]):
        d[k] += n


@contextlib.contextmanager
def sync_debug_error():
    """Raise on any operation that makes the host wait for the card."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


class StepGraph:
    """One captured step. `replay()` runs it; `outputs` (a dict of 0-dim
    tensors) and `packed` (the same stacked) hold the metrics of the last
    replay. The caller has run the step eagerly since the state last changed:
    capture records the step's launches without running them."""

    def __init__(self, step_fn, state: list, generator: torch.Generator):
        self.state = list(state)
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(generator)
        before = _counts()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(self.graph):
                self.outputs = step_fn()
                self.packed = torch.stack(list(self.outputs.values()))
            torch.cuda.synchronize()
        finally:
            launched = [a - b for b, a in zip(before, _counts())]
            _add_counts([-n for n in launched])      # the capture ran nothing: back to `before`
        self.capture_s = time.perf_counter() - t0
        self.launches = launched

    def holds(self, state: list) -> bool:
        """True while `state` is, tensor for tensor, what the graph captured."""
        return len(state) == len(self.state) and all(a is b for a, b in zip(state, self.state))

    def replay(self) -> None:
        self.graph.replay()
        _add_counts(self.launches)

    def reset(self) -> None:
        self.graph.reset()
        self.outputs = self.packed = None
        self.state = []


class GraphCache:
    """The captured step of the last cell. A window of another cell, or a
    state tensor rebound since the capture, drops it and returns its memory
    pool to the card."""

    def __init__(self):
        self.key, self.graph = None, None

    def get(self, key, state: list) -> StepGraph | None:
        if self.graph is not None and (self.key != key or not self.graph.holds(state)):
            self.clear()
        return self.graph

    def put(self, key, graph: StepGraph) -> StepGraph:
        self.clear()
        self.key, self.graph = key, graph
        return graph

    def clear(self) -> None:
        if self.graph is not None:
            self.graph.reset()
            self.key, self.graph = None, None
            torch.cuda.empty_cache()
