"""Grid ops of the benchmark's reference: a frozen copy of the port's plain
grid stack (`ops/grid.py`), with the trilinear lookup taken by its
independent twins (nested lerps over eight corner gathers, differentiated by
autograd) in place of the hand-written kernels and their plain versions.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.graphsafe import const


def normalize_coords(xyz, xyz_min, xyz_max):
    """World coords -> [0, 1] per axis (align_corners=True: xyz_min -> 0, xyz_max -> 1)."""
    return (xyz - xyz_min) / (xyz_max - xyz_min)


# ---------------------------------------------------------------------------
# independent twins: nested lerps, differentiated by autograd


def _prep(i, D: int):
    inside = (i >= 0.0) & (i <= D - 1.0)
    i = torch.clamp(i, 0.0, D - 1.0)
    i0 = torch.clamp(torch.floor(i), 0, D - 2).to(torch.int64)
    return i0, i - i0.to(i.dtype), inside.to(i.dtype)


def _scale(gshape, xyz_min, xyz_max):
    """d(index coordinate)/d(world coordinate) per axis, [3]."""
    _, X, Y, Z = gshape
    return const((X - 1, Y - 1, Z - 1), xyz_min.dtype, xyz_min.device) / (xyz_max - xyz_min)


def trilinear_vg_reference(grid, xyz, xyz_min, xyz_max):
    """grid [C, X, Y, Z], xyz [..., 3] -> (value [..., C], grad [..., C, 3]) by
    nested lerps over 8 row gathers; every gradient comes from autograd."""
    C, X, Y, Z = grid.shape
    shape = xyz.shape[:-1]
    pts = xyz.reshape(-1, 3)
    scale = _scale(grid.shape, xyz_min, xyz_max)
    u = normalize_coords(pts, xyz_min, xyz_max)
    x0, wx, mx = _prep(u[:, 0] * (X - 1), X)
    y0, wy, my = _prep(u[:, 1] * (Y - 1), Y)
    z0, wz, mz = _prep(u[:, 2] * (Z - 1), Z)
    x1, y1, z1 = x0 + 1, y0 + 1, z0 + 1
    flat = grid.reshape(C, -1).t()

    def gather(xi, yi, zi):
        return flat[(xi * Y + yi) * Z + zi]

    wx, wy, wz = wx[:, None], wy[:, None], wz[:, None]
    mx, my, mz = mx[:, None], my[:, None], mz[:, None]
    c000, c001 = gather(x0, y0, z0), gather(x0, y0, z1)
    c010, c011 = gather(x0, y1, z0), gather(x0, y1, z1)
    c100, c101 = gather(x1, y0, z0), gather(x1, y0, z1)
    c110, c111 = gather(x1, y1, z0), gather(x1, y1, z1)
    c00 = c000 * (1 - wz) + c001 * wz
    c01 = c010 * (1 - wz) + c011 * wz
    c10 = c100 * (1 - wz) + c101 * wz
    c11 = c110 * (1 - wz) + c111 * wz
    c0 = c00 * (1 - wy) + c01 * wy
    c1 = c10 * (1 - wy) + c11 * wy
    val = c0 * (1 - wx) + c1 * wx
    gx = (c1 - c0) * scale[0] * mx
    gy = ((c01 - c00) * (1 - wx) + (c11 - c10) * wx) * scale[1] * my
    dz0 = (c001 - c000) * (1 - wy) + (c011 - c010) * wy
    dz1 = (c101 - c100) * (1 - wy) + (c111 - c110) * wy
    gz = (dz0 * (1 - wx) + dz1 * wx) * scale[2] * mz
    grad = torch.stack([gx, gy, gz], dim=-1)
    return val.reshape(*shape, C), grad.reshape(*shape, C, 3)


def trilinear_sample_reference(grid, xyz, xyz_min, xyz_max):
    """Value-only twin of `trilinear_sample` ([..., 3] -> [..., C])."""
    return trilinear_vg_reference(grid, xyz, xyz_min, xyz_max)[0]




def _bounds_like(pts, xyz_min, xyz_max):
    f = lambda b: torch.as_tensor(b, dtype=pts.dtype, device=pts.device).contiguous()  # noqa: E731
    return f(xyz_min), f(xyz_max)


def trilinear_sample(grid, xyz, xyz_min, xyz_max):
    """Trilinearly interpolate grid [C, X, Y, Z] at world points [..., 3] -> [..., C]."""
    xyz_min, xyz_max = _bounds_like(xyz, xyz_min, xyz_max)
    return trilinear_sample_reference(grid, xyz, xyz_min, xyz_max)


def trilinear_sample_with_grad(grid, xyz, xyz_min, xyz_max):
    """Trilinear value and spatial gradient: (value [..., C], grad [..., C, 3])."""
    xyz_min, xyz_max = _bounds_like(xyz, xyz_min, xyz_max)
    return trilinear_vg_reference(grid, xyz, xyz_min, xyz_max)


# ---------------------------------------------------------------------------
# the rest of the grid stack (plain PyTorch)


def abs_one_sided(x: torch.Tensor) -> torch.Tensor:
    """|x| whose derivative at exactly 0 is +1, as `jax.numpy.abs` has it
    (`torch.abs` gives 0 there). It matters where a term starts at exact zero:
    the zero-initialised k0 grid's total variation and the deformation
    priors, whose first gradients the reference's optimizer does see."""
    return torch.where(x >= 0, x, -x)


def resize_trilinear(grid: torch.Tensor, new_size) -> torch.Tensor:
    """Trilinear grid resize [C, X, Y, Z] -> [C, *new_size] (align_corners=True).

    A size-1 source axis is read as two equal cells, which the lookup kernels
    take (they need 2 voxels per axis) and which give the same values."""
    grid = grid.expand(*[max(s, 2) if a else s for a, s in enumerate(grid.shape)])
    C, X, Y, Z = grid.shape
    nx, ny, nz = new_size
    dev = grid.device
    gx = torch.linspace(0.0, X - 1.0, nx, device=dev)
    gy = torch.linspace(0.0, Y - 1.0, ny, device=dev)
    gz = torch.linspace(0.0, Z - 1.0, nz, device=dev)
    pts = torch.stack(torch.meshgrid(gx, gy, gz, indexing="ij"), dim=-1)
    # index-space "world" bounds; a size-1 source axis has zero extent, so its
    # bound is clamped to keep the normalisation finite (its coords are 0)
    hi = const((max(X - 1.0, 1.0), max(Y - 1.0, 1.0), max(Z - 1.0, 1.0)), grid.dtype, dev)
    out = trilinear_sample(grid, pts, torch.zeros(3, dtype=grid.dtype, device=dev), hi)
    return out.movedim(-1, 0)


def total_variation(v: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean absolute difference over the 3 spatial axes of [C, X, Y, Z]:
    (sum tv_x + sum tv_y + sum tv_z) / 3 / (#mask or #elements)."""
    tv_x = abs_one_sided(v[:, 1:] - v[:, :-1])
    tv_y = abs_one_sided(v[:, :, 1:] - v[:, :, :-1])
    tv_z = abs_one_sided(v[:, :, :, 1:] - v[:, :, :, :-1])
    if mask is not None:
        mask = mask.to(v.dtype)
        tv_x = tv_x * (mask[:, 1:] * mask[:, :-1])
        tv_y = tv_y * (mask[:, :, 1:] * mask[:, :, :-1])
        tv_z = tv_z * (mask[:, :, :, 1:] * mask[:, :, :, :-1])
        denom = mask.sum()
    else:
        denom = float(v.numel())
    return (tv_x.sum() + tv_y.sum() + tv_z.sum()) / 3.0 / denom


def sdf_gradient_grid(sdf: torch.Tensor, voxel_size) -> torch.Tensor:
    """Central-difference spatial gradient of an SDF grid [1, X, Y, Z] ->
    [3, X, Y, Z], zero on the boundary slices."""
    gx = F.pad((sdf[0, 2:] - sdf[0, :-2]) / 2.0 / voxel_size, (0, 0, 0, 0, 1, 1))
    gy = F.pad((sdf[0, :, 2:] - sdf[0, :, :-2]) / 2.0 / voxel_size, (0, 0, 1, 1))
    gz = F.pad((sdf[0, :, :, 2:] - sdf[0, :, :, :-2]) / 2.0 / voxel_size, (1, 1))
    return torch.stack([gx, gy, gz])


def gaussian_kernel_3d(ksize: int, sigma: float, device="cuda") -> torch.Tensor:
    """Normalized [k, k, k] Gaussian kernel. No training path uses it: the
    trainers smooth with the separable 1-D factor."""
    r = torch.arange(-(ksize // 2), ksize // 2 + 1, dtype=torch.float32, device=device)
    xx, yy, zz = torch.meshgrid(r, r, r, indexing="ij")
    k = torch.exp(-(xx ** 2 + yy ** 2 + zz ** 2) / (2.0 * sigma ** 2))
    return k / k.sum()


def conv3d_replicate(grid: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise 3-D conv with replicate padding on [C, X, Y, Z]; only
    `smooth_grad_tv`'s full-kernel branch, which no training path takes,
    calls it."""
    k = kernel.shape[0]
    p = k // 2
    C = grid.shape[0]
    padded = F.pad(grid[None], (p,) * 6, mode="replicate")
    weight = kernel.to(grid.dtype)[None, None].expand(C, 1, k, k, k)
    return F.conv3d(padded, weight, groups=C)[0]


def conv3d_separable_replicate(grid: torch.Tensor, k1d: torch.Tensor) -> torch.Tensor:
    """Separable depthwise smoothing on [C, X, Y, Z] with the 3-D kernel
    k1d (x) k1d (x) k1d: three 1-D passes of edge padding and shifted adds."""
    k = int(k1d.shape[0])
    p = k // 2
    out = grid
    for axis in (1, 2, 3):
        n = out.shape[axis]
        first = out.narrow(axis, 0, 1).expand(*[p if a == axis else s for a, s in enumerate(out.shape)])
        last = out.narrow(axis, n - 1, 1).expand(*[p if a == axis else s for a, s in enumerate(out.shape)])
        padded = torch.cat([first, out, last], dim=axis)
        acc = None
        for i in range(k):
            term = k1d[i] * padded.narrow(axis, i, n)
            acc = term if acc is None else acc + term
        out = acc
    return out


def binomial_kernel_1d(device="cuda") -> torch.Tensor:
    """[1, 2, 1]/4, the separable factor of the 3x3x3 binomial TV-smooth kernel."""
    return const((0.25, 0.5, 0.25), torch.float32, device)


def gaussian_kernel_1d(ksize: int, sigma: float, device="cuda") -> torch.Tensor:
    """Normalized 1-D Gaussian."""
    r = torch.arange(-(ksize // 2), ksize // 2 + 1, dtype=torch.float32, device=device)
    k = torch.exp(-(r ** 2) / (2.0 * sigma ** 2))
    return k / k.sum()


def smooth_grad_tv(sdf_grad: torch.Tensor, smooth_kernel: torch.Tensor,
                   mask: torch.Tensor | None = None) -> torch.Tensor:
    """||smooth(grad).detach() - grad||^2. `smooth_kernel` is the separable
    1-D factor [k] (three 1-D passes; what every caller passes) or a full
    [k, k, k] kernel."""
    if smooth_kernel.ndim == 1:
        smoothed = conv3d_separable_replicate(sdf_grad, smooth_kernel).detach()
    else:
        smoothed = conv3d_replicate(sdf_grad, smooth_kernel).detach()
    err = (smoothed - sdf_grad) ** 2
    if mask is not None:
        err = err * mask.to(err.dtype)
        return err.sum() / torch.clamp(mask.sum() * 3.0, min=1.0)
    return err.mean()
