"""What keeps the training step capturable by a CUDA graph.

A captured step may only launch work on the device: it may not copy from
pageable host memory (`torch.tensor(..., device="cuda")` does) or read a
value back to the host (indexing with a CUDA scalar tensor may). The step's
constants therefore come from `const`, made once per (values, dtype, device)
by an asynchronous copy from pinned memory, before the capture, and reused
after; its picks of one row by a drawn index go through `take` and `index`.
"""
from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _make(values: tuple, dtype, device):
    if device.type != "cuda":
        return torch.tensor(values, dtype=dtype, device=device)
    # an asynchronous copy from pinned memory: the first step of a cell, which
    # runs under the sync-debug error mode before the capture, makes its
    # constants without a synchronisation
    return torch.tensor(values, dtype=dtype).pin_memory().to(device, non_blocking=True)


def const(values: tuple, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """The tensor of `values` (a tuple of numbers) on `device`, made at the
    first call and shared after: never write into it."""
    return _make(values, dtype, torch.device(device))


def take(x: torch.Tensor, i) -> torch.Tensor:
    """x[i] along the first axis, for an int or a 0-dim integer tensor."""
    if isinstance(i, torch.Tensor):
        return x.index_select(0, i.reshape(1).to(x.device)).squeeze(0)
    return x[i]


def index(ids, device) -> torch.Tensor:
    """A 1-d int64 index on `device` from ints and 0-dim integer tensors."""
    if not any(isinstance(i, torch.Tensor) for i in ids):
        return const(tuple(int(i) for i in ids), torch.int64, device)
    return torch.stack([torch.as_tensor(i, device=device).reshape(()).to(torch.int64) for i in ids])
