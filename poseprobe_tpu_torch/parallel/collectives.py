"""A mesh of ranks on `torch.distributed` and the collectives the parallel
modules differentiate through.

The JAX package runs one program over a `jax.sharding.Mesh` of devices and
lets `shard_map` / GSPMD place the collectives. Here every rank is a process
of its own (`torch.distributed`, one process group per line of each mesh
axis), and each rank computes on its own card. `Mesh` is the port's own
small class rather than `torch.distributed.device_mesh.DeviceMesh`: two
ranks may share one card (gloo on `cuda:0`, the only way to run two ranks on
a one-card machine; NCCL refuses two ranks on one device), which a device
mesh, binding each rank to a device of its own, does not describe.

Every collective is one `all_reduce` (sum). It runs on NCCL, on gloo with
CPU tensors and on gloo with CUDA tensors (gloo's send / recv take CPU
tensors only). A permutation or an all-gather is an `all_reduce` of a zeroed
buffer with one slot per rank, each rank writing its own slot.

The autograd rules are JAX's, for a value that every rank computes alike
("invariant") and one that differs between ranks ("varying"):

* `psum` (varying -> invariant): the forward sums over the axis; the
  backward passes the cotangent through unchanged. Every rank computes the
  same replicated loss from the sum, so each rank already holds the whole
  cotangent; an all-reduce there (what `torch.distributed.nn`'s all_reduce
  does) would count it once per rank.
* `pcast` (invariant -> varying): the forward is the identity; the backward
  sums the cotangents over the axis, because each rank's varying math used
  the one replicated value.
* `all_gather` (varying -> invariant, along a tensor dim): the backward takes
  this rank's slice of the cotangent. With ``varying=True`` the gathered
  value is read by rank-dependent math (a halo plane, a per-rank loss), and
  the backward first sums the cotangents over the axis (`pcast` then gather).

All three skip the collective on an axis of size 1.
"""
from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its size, this rank's index along
    it and the process group of the ranks that differ from this one only in
    that index (None: every rank of the job)."""
    name: str
    size: int
    index: int
    group: object


class Mesh:
    """Ranks laid out on a grid with named axes (row-major: the last axis
    varies fastest with the rank). Every rank of the job constructs the same
    mesh, in the same order as every other mesh it constructs (group creation
    is collective). `device` is this rank's device (`local_device` of the
    `device` asked for); `all_reduces` counts the collectives this rank has
    issued (a captured CUDA graph issues its own at each replay without
    counting them)."""

    def __init__(self, names: tuple, sizes: tuple, device="cuda"):
        world, rank = dist.get_world_size(), dist.get_rank()
        if math.prod(sizes) != world:
            raise ValueError(f"a mesh of {dict(zip(names, sizes))} needs {math.prod(sizes)} ranks, "
                             f"the job has {world}")
        self.names, self.sizes = tuple(names), tuple(int(s) for s in sizes)
        self.rank = rank
        self.backend = dist.get_backend()
        self.device = local_device(device)
        self.all_reduces = 0
        grid = np.arange(world).reshape(self.sizes)
        coords = np.unravel_index(rank, self.sizes)
        self._axes = {}
        for a, name in enumerate(self.names):
            lines = np.moveaxis(grid, a, -1).reshape(-1, self.sizes[a])
            own = None
            for line in lines:           # every rank creates every group, in one order
                group = None if len(line) == world else dist.new_group([int(r) for r in line])
                if rank in line:
                    own = group
            self._axes[name] = Axis(name, self.sizes[a], int(coords[a]), own)

    @property
    def shape(self) -> dict:
        return dict(zip(self.names, self.sizes))

    def axis(self, name: str) -> Axis:
        return self._axes[name]

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can hold this mesh's collectives (NCCL: yes;
        gloo stages through the host and cannot be captured)."""
        return self.backend == "nccl" and self.device.type == "cuda"

    def all_reduce_(self, t: torch.Tensor, axis: Axis | None = None) -> torch.Tensor:
        """Sum `t` in place over `axis` (None: every rank of the mesh)."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=None if axis is None else axis.group)
        self.all_reduces += 1
        return t


def local_device(device="cuda") -> torch.device:
    """This rank's device: the CPU when `device` asks for it, a card that
    `device` names by its index, else ``cuda:{LOCAL_RANK % device_count}``
    (two ranks share a card when there are more ranks than cards). Raises
    without a card unless the CPU was asked for."""
    device = torch.device(device)
    if device.type == "cpu":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for this rank's mesh (pass device='cpu' to run on the CPU)")
    if device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device(f"cuda:{local % torch.cuda.device_count()}")


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce_(x.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _PCast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_(g.contiguous().clone(), ctx.axis), None, None


class _Gather(torch.autograd.Function):
    """All-gathers several float32 tensors along their own dims in one
    all-reduce of a [size, sum of numels] slot buffer."""

    @staticmethod
    def forward(ctx, mesh, axis, dims, varying, *xs):
        ctx.mesh, ctx.axis, ctx.dims, ctx.varying = mesh, axis, dims, varying
        ctx.shapes = [x.shape for x in xs]
        buf = xs[0].new_zeros((axis.size, sum(x.numel() for x in xs)))
        buf[axis.index] = torch.cat([x.reshape(-1) for x in xs])
        mesh.all_reduce_(buf, axis)
        outs, off = [], 0
        for shape, d in zip(ctx.shapes, dims):
            n = math.prod(shape)
            slots = buf[:, off:off + n].reshape(axis.size, *shape)
            outs.append(slots.movedim(0, d).reshape(*shape[:d], axis.size * shape[d], *shape[d + 1:]))
            off += n
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        axis, G = ctx.axis, ctx.axis.size
        if ctx.varying:
            # [size, local numel] per tensor: slot r holds the cotangent of rank r's slice
            parts = [g.reshape(*s[:d], G, s[d], *s[d + 1:]).movedim(d, 0).reshape(G, -1)
                     for g, s, d in zip(gs, ctx.shapes, ctx.dims)]
            row = ctx.mesh.all_reduce_(torch.cat(parts, dim=1), axis)[axis.index]
            grads = [t.reshape(s) for t, s in zip(row.split([math.prod(s) for s in ctx.shapes]), ctx.shapes)]
        else:
            grads = [g.narrow(d, axis.index * s[d], s[d]) for g, s, d in zip(gs, ctx.shapes, ctx.dims)]
        return (None, None, None, None, *grads)


def psum(x: torch.Tensor, mesh: Mesh, axis: Axis) -> torch.Tensor:
    """Sum over `axis`; the backward passes the cotangent through (JAX's
    transpose of a psum to an invariant value)."""
    return x if axis.size == 1 else _PSum.apply(x, mesh, axis)


def pcast(x: torch.Tensor, mesh: Mesh, axis: Axis) -> torch.Tensor:
    """A replicated value entering rank-dependent math: the identity, whose
    backward sums the cotangents over `axis`."""
    return x if axis.size == 1 else _PCast.apply(x, mesh, axis)


def all_gather(xs: list, mesh: Mesh, axis: Axis, dims: list, varying: bool = False) -> list:
    """Concatenate each tensor of `xs` over the ranks of `axis` along its dim
    in `dims` (ranks in index order, equal shapes on every rank), in one
    all-reduce. The backward takes this rank's slice of each cotangent,
    summed over the axis first when `varying` (see the module docstring).
    Every tensor travels as float32 (bool masks and small ints exactly);
    only floating tensors carry a gradient back."""
    if axis.size == 1:
        return list(xs)
    dtypes = [x.dtype for x in xs]
    outs = _Gather.apply(mesh, axis, tuple(dims), varying, *[x.to(torch.float32) for x in xs])
    return [o.to(dt) if dt.is_floating_point else o.detach().to(dt) for o, dt in zip(outs, dtypes)]


def broadcast_(tensors: list, mesh: Mesh) -> list:
    """Copy mesh rank 0's values into `tensors` on every rank, in place and
    bit for bit: the bytes of all of them in one uint8 all-reduce, to which
    every other rank adds zeros."""
    flat = [t.detach().contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    if not flat:
        return tensors
    buf = torch.cat(flat) if mesh.rank == 0 else torch.zeros(sum(f.numel() for f in flat),
                                                             dtype=torch.uint8, device=flat[0].device)
    mesh.all_reduce_(buf)
    off = 0
    with torch.no_grad():
        for t, f in zip(tensors, flat):
            # a copy of the slice starts at offset 0, as a view as a wider dtype needs
            t.copy_(buf[off:off + f.numel()].clone().view(t.dtype).reshape(t.shape))
            off += f.numel()
    return tensors
