"""Process-group set-up for a job of many ranks, on one host or many.

Port of `poseprobe_tpu/parallel/multihost.py`:

* `init_distributed()` -- `torch.distributed.init_process_group` with its
  arguments resolved from explicit arguments first, then torchrun's
  environment (`MASTER_ADDR` / `MASTER_PORT` through the ``env://``
  rendezvous, `WORLD_SIZE`, `RANK`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE`). A job
  of one rank is a no-op, so one entry point runs alone and under
  ``torchrun --nproc_per_node=N``. The backend is NCCL when every local rank
  has a card of its own, else gloo: on the CPU, or with more ranks than cards
  on a host (NCCL refuses two ranks on one device; gloo takes CUDA tensors
  for `all_reduce` and leaves every tensor on the card).

The mesh over every rank of the job is `mesh.make_mesh()`.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist


def init_distributed(init_method: str | None = None, world_size: int | None = None,
                     rank: int | None = None, backend: str | None = None,
                     timeout_s: float = 600.0) -> bool:
    """Join the job's process group; returns True if one was initialised.

    Resolution order: explicit arguments, then the environment (`WORLD_SIZE`,
    `RANK`; without `init_method` torch reads `MASTER_ADDR` / `MASTER_PORT`).
    A world size of at most 1 is a no-op returning False; a larger one without
    a rank raises `ValueError`. On a machine with cards, this rank's card
    becomes the current device (``LOCAL_RANK`` modulo the card count, the
    device `collectives.local_device` gives the rank's mesh)."""
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if world_size is None or world_size <= 1:
        return False
    if rank is None:
        raise ValueError("a job of many ranks needs the rank of this process (argument or $RANK)")
    if backend is None:
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        backend = "nccl" if torch.cuda.is_available() and torch.cuda.device_count() >= local_world else "gloo"
    if torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count())
    dist.init_process_group(backend=backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return True

