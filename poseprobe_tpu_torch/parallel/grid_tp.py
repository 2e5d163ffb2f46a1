"""Grid tensor parallelism: Z-sharded dense voxel grids with a halo plane.

Port of `poseprobe_tpu/parallel/grid_tp.py`. A [C, X, Y, Z] grid lives cut
along Z over the ``'grid'`` axis of a 2-D ``('data', 'grid')`` mesh: rank
``s`` of ``G`` holds planes ``[s*Zl, (s+1)*Zl)`` (`shard_grid`). A trilinear
read across a slab's +Z face needs the next slab's first plane: the halo
(`_halo_extend`), which the JAX package moves with `ppermute` and this port
with one all-reduce of a zeroed [G, C, X, Y] slot buffer (rank ``s`` writes
its first plane into slot ``s`` and reads slot ``s + 1``). The last slab has
no neighbour and appends a copy of its own last plane, which reproduces the
global border clamp: the same values, and a zero z-slope there.

Every query point has one owner, the slab that holds ``floor(iz)``. Each
rank samples all its points against its extended slab with the world bounds
rebased to the slab (the align-corners index map is linear, so an owned
point's value matches the global lookup to float32 rounding of the rebased
coordinate), zeroes the points it does not own, and a `psum` over the grid
axis assembles the result. The sample is the port's `ops/grid.trilinear_sample`,
so on the card every sharded read runs the hand-written trilinear kernels.

Gradients follow JAX's rules (`parallel/collectives.py`): the points and the
bounds enter the rank-dependent math through a `pcast` over the grid axis
(their gradient is the sum over the slabs), and with data-sharded points the
grid and the bounds enter through a `pcast` over the data axis (the grid's
gradient sums every ray shard's); the halo's backward moves a plane's
cotangent back to the rank that owns the plane. Exactly on a cell seam the
trilinear derivative is one-sided and the rebased coordinate can round to the
other side than the global one, as in the JAX package: values are continuous
there, point gradients may take the abutting cell's slope.

With ``mesh=None`` `sample_grid_tp` is the unsharded lookup of the whole
grid (the unsharded steps of `object_tp.py` run through it).
"""
from __future__ import annotations

import torch

from ..ops import grid as grid_ops
from .collectives import Mesh, all_gather, pcast, psum
from .mesh import DATA_AXIS

GRID_AXIS = "grid"


def make_grid_mesh(n_data: int, n_grid: int, device="cuda") -> Mesh:
    """The 2-D ``('data', 'grid')`` mesh (rays data-parallel x grid
    tensor-parallel) over the job's ``n_data * n_grid`` ranks, on this rank's
    card or the CPU (`collectives.local_device`)."""
    return Mesh((DATA_AXIS, GRID_AXIS), (n_data, n_grid), device)


def shard_grid(grid: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's Z slab of a [C, X, Y, Z] grid (a copy)."""
    Z, axis = grid.shape[-1], mesh.axis(GRID_AXIS)
    if Z % axis.size != 0:
        raise ValueError(f"grid Z={Z} not divisible by grid axis size {axis.size}")
    Zl = Z // axis.size
    return grid[..., axis.index * Zl:(axis.index + 1) * Zl].clone()


def _halo_extend(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[..., Zl] slab -> [..., Zl + 1] with the +Z neighbour's first plane
    (the last slab: its own last plane)."""
    axis = mesh.axis(GRID_AXIS)
    firsts = all_gather([local[..., :1].movedim(-1, 0)], mesh, axis, [0], varying=True)[0]
    last = torch.full((), axis.index == axis.size - 1, dtype=torch.bool, device=local.device)
    # both branches stay in the graph on every rank, so every rank's backward
    # joins the halo's all-reduce
    halo = torch.where(last, local[..., -1], firsts[(axis.index + 1) % axis.size])
    return torch.cat([local, halo[..., None]], dim=-1)


def sample_grid_tp(grid_local: torch.Tensor, xyz: torch.Tensor, xyz_min, xyz_max,
                   mesh: Mesh | None, data_sharded_points: bool = False) -> torch.Tensor:
    """Trilinear sampling of a Z-sharded grid: the values (and gradients, the
    border clamp included) of `ops.grid.trilinear_sample` on the whole grid.

    grid_local: this rank's [C, X, Y, Zl] slab (`shard_grid`); xyz: [..., 3]
    world points, the same on every rank of the grid axis; with
    ``data_sharded_points`` they are this rank's share of the points, which
    differ along the data axis. Returns [..., C] for the points given."""
    if mesh is None:
        return grid_ops.trilinear_sample(grid_local, xyz, xyz_min, xyz_max)
    C, _, _, Zl = grid_local.shape
    gaxis = mesh.axis(GRID_AXIS)
    s, Z = gaxis.index, Zl * gaxis.size
    batch_shape = xyz.shape[:-1]
    lo, hi = grid_ops._bounds_like(xyz, xyz_min, xyz_max)
    pts = pcast(xyz.reshape(-1, 3), mesh, gaxis)
    lo, hi = pcast(lo, mesh, gaxis), pcast(hi, mesh, gaxis)
    if data_sharded_points:
        daxis = mesh.axis(DATA_AXIS)
        grid_local = pcast(grid_local, mesh, daxis)
        lo, hi = pcast(lo, mesh, daxis), pcast(hi, mesh, daxis)
    gext = _halo_extend(grid_local, mesh)
    vz = (hi[2] - lo[2]) / (Z - 1)
    zmin_s = lo[2] + float(s) * Zl * vz
    lmin = torch.stack([lo[0], lo[1], zmin_s])
    lmax = torch.stack([hi[0], hi[1], zmin_s + Zl * vz])
    out = grid_ops.trilinear_sample(gext, pts, lmin, lmax)                # [N, C]
    with torch.no_grad():
        iz = (pts[:, 2] - lo[2]) / (hi[2] - lo[2]) * (Z - 1)
        z0 = torch.clamp(torch.floor(torch.clamp(iz, 0.0, Z - 1.0)), 0, Z - 2)
        own = torch.div(z0.to(torch.int64), Zl, rounding_mode="floor") == s
    out = psum(torch.where(own[:, None], out, 0.0), mesh, gaxis)
    return out.reshape(*batch_shape, C)


def total_variation_tp(v_local: torch.Tensor, mesh: Mesh,
                       mask_local: torch.Tensor | None = None) -> torch.Tensor:
    """TV loss of a Z-sharded grid: `ops.grid.total_variation` of the whole
    grid. x / y pairs lie inside a slab; z pairs across a slab's +Z face use
    the halo plane, so each pair counts once (the last slab's duplicated halo
    adds a zero difference). The sums are `psum`-reduced and divided by the
    global element or mask count."""
    gaxis = mesh.axis(GRID_AXIS)
    C, X, Y, Zl = v_local.shape
    absd = grid_ops.abs_one_sided
    vext = _halo_extend(v_local, mesh)
    tv_x = absd(v_local[:, 1:] - v_local[:, :-1])
    tv_y = absd(v_local[:, :, 1:] - v_local[:, :, :-1])
    tv_z = absd(vext[..., 1:] - vext[..., :-1])
    if mask_local is not None:
        mext = _halo_extend(mask_local.to(v_local.dtype), mesh)
        mloc = mext[..., :-1]
        tv_x = tv_x * (mloc[:, 1:] * mloc[:, :-1])
        tv_y = tv_y * (mloc[:, :, 1:] * mloc[:, :, :-1])
        tv_z = tv_z * (mext[..., 1:] * mext[..., :-1])
        denom = psum(mloc.sum(), mesh, gaxis)
    else:
        denom = float(C * X * Y * Zl * gaxis.size)
    total = psum(tv_x.sum() + tv_y.sum() + tv_z.sum(), mesh, gaxis)
    return total / 3.0 / denom
