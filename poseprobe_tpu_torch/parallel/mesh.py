"""Ray data parallelism over a 1-D ``('data',)`` mesh of ranks.

Port of `poseprobe_tpu/parallel/mesh.py`. The JAX trainer constrains its ray
batches to be sharded over the mesh and lets GSPMD insert the gradient psum.
Here each rank is a process (`parallel/collectives.py`) that holds the
replicated parameters and the same generator seed, so every rank draws the
whole batch, exactly as the JAX step samples the whole batch before it
constrains the sharding; `shard_rays` then takes this rank's slice and
`unshard_rays` puts the per-ray outputs back together on every rank, so that
every rank computes the same full loss. The trainer sums the gradients over
the ranks and divides by their number (`train/trainer.py`): the gather's
backward sums the cotangents over the ranks, so each rank's ray gradient is
the world size times its own share, and each rank adds the terms that are no
function of the rays (the total-variation terms, the priors) once, so the
quotient is the single-device gradient.

`replicated` is the broadcast from rank 0 after a host event that rebinds
state, so that ranks cannot drift apart through OpenCV's RANSAC or host
floats.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..core.tree import tree_leaves
from .collectives import Mesh, all_gather, broadcast_

DATA_AXIS = "data"


def make_mesh(device="cuda") -> Mesh:
    """A 1-D ``('data',)`` mesh over every rank of the job; its device is
    this rank's card, or the CPU when `device` asks for it
    (`collectives.local_device`)."""
    return Mesh((DATA_AXIS,), (dist.get_world_size(),), device)


def _share(n: int, mesh: Mesh | None):
    """(start, length) of this rank's share of `n` rays, or None where the
    rays stay whole on every rank (no mesh, or `n` not divisible)."""
    if mesh is None:
        return None
    axis = mesh.axis(DATA_AXIS)
    if axis.size == 1 or n % axis.size:
        return None
    return axis.index * (n // axis.size), n // axis.size


def shard_rays(x: torch.Tensor, mesh: Mesh | None, axis: int = 0) -> torch.Tensor:
    """This rank's slice of a ray batch along `axis`. A no-op without a mesh;
    a length that does not divide over the ranks stays whole on every rank
    (the JAX package's eager branch does the same)."""
    share = _share(x.shape[axis], mesh)
    return x if share is None else x.narrow(axis, *share)


def unshard_rays(outs: dict, n: int, mesh: Mesh | None, axis: int = 0) -> dict:
    """The inverse of `shard_rays` for a dict of per-ray outputs of `n` rays:
    every tensor whose dim `axis` holds this rank's share is gathered to all
    `n` rays on every rank, all in one all-reduce; other values pass through.
    The backward sums the cotangents over the ranks (see the module
    docstring)."""
    share = _share(n, mesh)
    if share is None:
        return outs
    keys = [k for k, v in outs.items()
            if isinstance(v, torch.Tensor) and v.dim() > axis and v.shape[axis] == share[1]]
    full = all_gather([outs[k] for k in keys], mesh, mesh.axis(DATA_AXIS), [axis] * len(keys), varying=True)
    return {**outs, **dict(zip(keys, full))}


def mean_grads(grads: list, mesh: Mesh) -> list:
    """The mean over the data axis of every rank's gradients, in one flat
    all-reduce (issued even on an axis of one rank, so that a captured step
    holds it)."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    axis = mesh.axis(DATA_AXIS)
    mesh.all_reduce_(flat, axis).div_(axis.size)
    return [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)]


def replicated(tree, mesh: Mesh | None):
    """Rank 0's values in every tensor of `tree` (nested dicts / lists /
    tuples), in place, bit for bit; returns `tree`. A no-op without a mesh."""
    if mesh is None:
        return tree
    broadcast_([t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)], mesh)
    return tree
