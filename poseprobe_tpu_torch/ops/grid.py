"""Dense voxel grid primitives: trilinear sampling, rescaling, total variation.

Port of `poseprobe_tpu/ops/grid.py`. Grids are plain tensors [C, X, Y, Z];
`border` padding semantics (clamp) match
`F.grid_sample(..., padding_mode="border", align_corners=True)` with world x
indexing grid dim 0.

The trilinear sampler works on the grid's own layout in both directions: its
forward gathers the 8 corners of every point straight from [C, X, Y, Z] and
its hand-written backward adds the per-corner contributions straight into a
zeroed [C, X, Y, Z] gradient; nothing is transposed. On the TPU the gather
and the scatter were XLA ops around the Pallas layout kernels
(`ops/layout.py`); here both are hand-written Hopper kernels
(`poseprobe_tpu_torch/csrc/trilinear.cu`, sm_90a, one thread per point):
`trilinear_fwd` for `_trilinear_value` and `_trilinear_vg` (value and
analytic spatial gradient), `trilinear_bwd` for their VJPs (`d_pts` by the
closed-form cross terms, summed over the channels and stored; `d_grid` by
float atomics, so it sums in a run-dependent order and agrees with the plain
versions to float32 rounding, not bitwise). With `POSEPROBE_SCATTER_BARRIER=1`
(the JAX package's switch) the multi-channel updates are written out, passed
through `layout.materialize` and added by a second kernel, as the reference
does at that edge. The reference's window-scatter and window-gather
experiments (`POSEPROBE_WINDOW_SCATTER`, `POSEPROBE_WINDOW_GATHER`,
`POSEPROBE_PIN_LAYOUT`) steer XLA lowerings that do not exist here and are
not ported.

Beside each kernel wrapper stands its plain version (`trilinear_fwd_plain`,
`trilinear_bwd_plain`: the same formulas in PyTorch ops, run for tensors on
the CPU), and beside those the independent twins `trilinear_sample_reference`
and `trilinear_vg_reference` (nested lerps differentiated by autograd), which
the tests and `chip_smoke.py` hold both against. No `F.grid_sample` anywhere in
the port: `chip_smoke.py` alone times it, as the library's call for the same
function.
"""
from __future__ import annotations

import functools
import os

import torch
import torch.nn.functional as F

from ..core.graphsafe import const
from . import _build, layout
from ._build import check as _check, ptr as _ptr

# launch counts of the kernels; the CPU plain versions do not count
fwd_launches = 0
bwd_launches = 0


def _scatter_barrier() -> bool:
    """Pass the multi-channel scatter updates through `layout.materialize`
    before they are added (POSEPROBE_SCATTER_BARRIER=1)."""
    return os.environ.get("POSEPROBE_SCATTER_BARRIER", "0") == "1"


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


# ---------------------------------------------------------------------------
# plain versions of the kernels: the same formulas in PyTorch ops

_CORNER_I = (0, 0, 0, 0, 1, 1, 1, 1)   # +x bit of corner c (bit 2)
_CORNER_J = (0, 0, 1, 1, 0, 0, 1, 1)   # +y (bit 1)
_CORNER_K = (0, 1, 0, 1, 0, 1, 0, 1)   # +z (bit 0)


def _corner_data(gshape, pts, xyz_min, xyz_max):
    """idx8 [N, 8] flat corner ids, per-corner factors AX, AY, AZ [N, 8], signs
    [8] per axis and scale*mask per axis [N, 1]."""
    _, X, Y, Z = gshape
    u = normalize_coords(pts, xyz_min, xyz_max)
    scale = _scale(gshape, xyz_min, xyz_max)
    x0, wx, mx = _prep(u[:, 0] * (X - 1), X)
    y0, wy, my = _prep(u[:, 1] * (Y - 1), Y)
    z0, wz, mz = _prep(u[:, 2] * (Z - 1), Z)
    base = (x0 * Y + y0) * Z + z0
    offs = const((0, 1, Z, Z + 1, Y * Z, Y * Z + 1, Y * Z + Z, Y * Z + Z + 1), torch.int64, pts.device)
    idx8 = base[:, None] + offs[None, :]
    ax = torch.stack([1 - wx, wx], -1)
    ay = torch.stack([1 - wy, wy], -1)
    az = torch.stack([1 - wz, wz], -1)
    AX, AY, AZ = ax[:, _CORNER_I], ay[:, _CORNER_J], az[:, _CORNER_K]
    sign = lambda bits: const(tuple(2.0 * b - 1.0 for b in bits), pts.dtype, pts.device)  # noqa: E731
    sm = (scale[0] * mx[:, None], scale[1] * my[:, None], scale[2] * mz[:, None])
    return idx8, (AX, AY, AZ), (sign(_CORNER_I), sign(_CORNER_J), sign(_CORNER_K)), sm


def _rows(grid):
    """grid [C, X, Y, Z] -> a [V, C] view (or copy) of its voxels' channel rows."""
    return grid.reshape(grid.shape[0], -1).t()


def trilinear_fwd_plain(grid, pts, xyz_min, xyz_max, with_grad: bool):
    """grid [C, X, Y, Z], pts [N, 3] -> (val [N, C], grad [N, C, 3] or None)."""
    idx8, (AX, AY, AZ), (SX, SY, SZ), (sxm, sym, szm) = _corner_data(grid.shape, pts, xyz_min, xyz_max)
    vals = _rows(grid)[idx8]                                      # [N, 8, C]
    val = torch.einsum("nc,ncd->nd", AX * AY * AZ, vals)
    if not with_grad:
        return val, None
    gx = torch.einsum("nc,ncd->nd", SX * AY * AZ, vals) * sxm
    gy = torch.einsum("nc,ncd->nd", SY * AX * AZ, vals) * sym
    gz = torch.einsum("nc,ncd->nd", SZ * AX * AY, vals) * szm
    return val, torch.stack([gx, gy, gz], dim=-1)


def trilinear_bwd_plain(grid, pts, xyz_min, xyz_max, ct_v, ct_g,
                        need_grid: bool = True, need_pts: bool = True):
    """The VJP of `trilinear_fwd_plain`: cotangents ct_v [N, C] and ct_g
    [N, C, 3] (either may be None) -> (d_grid [C, X, Y, Z], d_pts [N, 3])."""
    gshape = tuple(grid.shape)
    C, N = gshape[0], pts.shape[0]
    V = gshape[1] * gshape[2] * gshape[3]
    idx8, (AX, AY, AZ), (SX, SY, SZ), (sxm, sym, szm) = _corner_data(gshape, pts, xyz_min, xyz_max)
    zero = pts.new_zeros((N, C))
    ct_v = zero if ct_v is None else ct_v
    ct_gx, ct_gy, ct_gz = (zero, zero, zero) if ct_g is None else ct_g.unbind(-1)
    d_grid = d_pts = None
    if need_grid:
        contrib = ((AX * AY * AZ)[..., None] * ct_v[:, None, :]
                   + (SX * AY * AZ * sxm)[..., None] * ct_gx[:, None, :]
                   + (SY * AX * AZ * sym)[..., None] * ct_gy[:, None, :]
                   + (SZ * AX * AY * szm)[..., None] * ct_gz[:, None, :])          # [N, 8, C]
        up = contrib.permute(2, 0, 1).reshape(C, -1)                                # [C, N*8]
        if C > 1 and _scatter_barrier():
            up = layout.materialize(up)
        d_grid = pts.new_zeros((C, V)).index_add_(1, idx8.reshape(-1), up).reshape(gshape)
    if need_pts:
        vals = _rows(grid)[idx8]
        v_v = torch.einsum("ncd,nd->nc", vals, ct_v)
        v_gx = torch.einsum("ncd,nd->nc", vals, ct_gx)
        v_gy = torch.einsum("ncd,nd->nc", vals, ct_gy)
        v_gz = torch.einsum("ncd,nd->nc", vals, ct_gz)
        d_wx = ((v_v * SX * AY * AZ).sum(-1, keepdim=True)
                + (v_gy * SY * SX * AZ).sum(-1, keepdim=True) * sym
                + (v_gz * SZ * SX * AY).sum(-1, keepdim=True) * szm)
        d_wy = ((v_v * SY * AX * AZ).sum(-1, keepdim=True)
                + (v_gx * SX * SY * AZ).sum(-1, keepdim=True) * sxm
                + (v_gz * SZ * SY * AX).sum(-1, keepdim=True) * szm)
        d_wz = ((v_v * SZ * AX * AY).sum(-1, keepdim=True)
                + (v_gx * SX * SZ * AY).sum(-1, keepdim=True) * sxm
                + (v_gy * SY * SZ * AX).sum(-1, keepdim=True) * sym)
        d_pts = torch.cat([d_wx * sxm, d_wy * sym, d_wz * szm], dim=-1)
    return d_grid, d_pts


# ---------------------------------------------------------------------------
# kernel wrappers


@functools.lru_cache(maxsize=None)
def _lib():
    return _build.declare(_build.load("trilinear"), trilinear_fwd="ppppiiiilppp",
                          trilinear_bwd="ppppppiiiilppppp", scatter_rows="pppllip")


def _check_inputs(grid, pts, xyz_min, xyz_max, **cts) -> None:
    """Raise on what the kernels do not take: every tensor contiguous float32
    on the points' device, the grid [C, X, Y, Z] with 2 voxels per axis."""
    if grid.ndim != 4:
        raise ValueError(f"grid: expected [C, X, Y, Z], got {tuple(grid.shape)}")
    C, X, Y, Z = grid.shape
    if C < 1 or min(X, Y, Z) < 2:
        raise ValueError(f"the trilinear kernels need a channel and 2 voxels per axis, got {tuple(grid.shape)}")
    if X * Y * Z >= 2 ** 31:
        raise ValueError(f"grid {tuple(grid.shape)} too large for 32-bit voxel ids")
    shapes = dict(pts=(pts.shape[0], 3), xyz_min=(3,), xyz_max=(3,))
    tensors = dict(grid=grid, pts=pts, xyz_min=xyz_min, xyz_max=xyz_max, **cts)
    for name, t in tensors.items():
        if t is None:
            continue
        if (t.device != pts.device or t.dtype != torch.float32 or not t.is_contiguous()
                or (name in shapes and tuple(t.shape) != shapes[name])):
            raise ValueError(f"{name}: expected a contiguous float32 tensor"
                             f"{' of shape ' + str(shapes[name]) if name in shapes else ''} on "
                             f"{pts.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def trilinear_fwd(grid, pts, xyz_min, xyz_max, with_grad: bool):
    """grid [C, X, Y, Z], pts [N, 3], bounds [3] -> (val [N, C], grad
    [N, C, 3] or None). Kernel on CUDA tensors, plain version on CPU ones."""
    global fwd_launches
    if not pts.is_cuda:
        return trilinear_fwd_plain(grid, pts, xyz_min, xyz_max, with_grad)
    _check_inputs(grid, pts, xyz_min, xyz_max)
    C, X, Y, Z = grid.shape
    N = pts.shape[0]
    val = torch.empty((N, C), dtype=torch.float32, device=pts.device)
    grad = torch.empty((N, C, 3), dtype=torch.float32, device=pts.device) if with_grad else None
    if N == 0:
        return val, grad
    lib = _lib()
    stream = torch.cuda.current_stream(pts.device).cuda_stream
    _check(lib, lib.trilinear_fwd(_ptr(grid), _ptr(pts), _ptr(xyz_min), _ptr(xyz_max), X, Y, Z, C, N,
                                  _ptr(val), _ptr(grad), stream), "trilinear_fwd")
    fwd_launches += 1
    return val, grad


def trilinear_bwd(grid, pts, xyz_min, xyz_max, ct_v, ct_g,
                  need_grid: bool = True, need_pts: bool = True):
    """The VJP of `trilinear_fwd`: (d_grid [C, X, Y, Z] or None, d_pts [N, 3]
    or None). Kernel on CUDA tensors, plain version on CPU ones."""
    global bwd_launches
    if not pts.is_cuda:
        return trilinear_bwd_plain(grid, pts, xyz_min, xyz_max, ct_v, ct_g, need_grid, need_pts)
    gshape = tuple(grid.shape)
    C, X, Y, Z = gshape
    N, V = pts.shape[0], X * Y * Z
    _check_inputs(grid, pts, xyz_min, xyz_max, ct_v=ct_v, ct_g=ct_g)
    if ct_v is not None and tuple(ct_v.shape) != (N, C) or ct_g is not None and tuple(ct_g.shape) != (N, C, 3):
        raise ValueError("trilinear_bwd: cotangent shapes do not match [N, C] and [N, C, 3]")
    dev = pts.device
    # the kernel adds into the zeroed d_grid and stores every d_pts row
    d_grid = torch.zeros(gshape, dtype=torch.float32, device=dev) if need_grid else None
    d_pts = torch.empty((N, 3), dtype=torch.float32, device=dev) if need_pts else None
    staged = need_grid and C > 1 and _scatter_barrier()
    up = torch.empty((C, N * 8), dtype=torch.float32, device=dev) if staged else None
    up_idx = torch.empty(N * 8, dtype=torch.int32, device=dev) if staged else None
    if N > 0 and (need_grid or need_pts):
        lib = _lib()
        stream = torch.cuda.current_stream(dev).cuda_stream
        _check(lib, lib.trilinear_bwd(_ptr(grid), _ptr(pts), _ptr(xyz_min), _ptr(xyz_max), _ptr(ct_v), _ptr(ct_g),
                                      X, Y, Z, C, N, None if staged else _ptr(d_grid), _ptr(up), _ptr(up_idx),
                                      _ptr(d_pts), stream), "trilinear_bwd")
        bwd_launches += 1
        if staged:
            up = layout.materialize(up)
            _check(lib, lib.scatter_rows(_ptr(up), _ptr(up_idx), _ptr(d_grid), V, N * 8, C, stream), "scatter_rows")
    return d_grid, d_pts


# ---------------------------------------------------------------------------
# autograd and the public entries


class _Trilinear(torch.autograd.Function):
    """with_grad=False: value only (the reference's `_trilinear_value`);
    True: value and spatial gradient (`_trilinear_vg`). First-order VJP only.
    Both directions read the grid in its own [C, X, Y, Z] layout."""

    @staticmethod
    def forward(ctx, grid, pts, xyz_min, xyz_max, with_grad):
        grid = grid.contiguous()
        val, grad = trilinear_fwd(grid, pts, xyz_min, xyz_max, with_grad)
        ctx.save_for_backward(grid, pts, xyz_min, xyz_max)
        if with_grad:
            return val, grad
        return val

    @staticmethod
    def backward(ctx, ct_v, ct_g=None):
        grid, pts, xyz_min, xyz_max = ctx.saved_tensors
        need_grid, need_pts = ctx.needs_input_grad[:2]
        ct_v = None if ct_v is None else ct_v.contiguous()
        ct_g = None if ct_g is None else ct_g.contiguous()
        d_grid, d_pts = trilinear_bwd(grid, pts, xyz_min, xyz_max, ct_v, ct_g, need_grid, need_pts)
        return d_grid, d_pts, None, None, None


def _bounds_like(pts, xyz_min, xyz_max):
    f = lambda b: torch.as_tensor(b, dtype=pts.dtype, device=pts.device).contiguous()  # noqa: E731
    return f(xyz_min), f(xyz_max)


def trilinear_sample(grid, xyz, xyz_min, xyz_max):
    """Trilinearly interpolate grid [C, X, Y, Z] at world points [..., 3] ->
    [..., C]. Coordinates outside the box clamp to the border."""
    xyz_min, xyz_max = _bounds_like(xyz, xyz_min, xyz_max)
    out = _Trilinear.apply(grid, xyz.reshape(-1, 3).contiguous(), xyz_min, xyz_max, False)
    return out.reshape(*xyz.shape[:-1], grid.shape[0])


def trilinear_sample_with_grad(grid, xyz, xyz_min, xyz_max):
    """Trilinear value and analytic spatial gradient:
    grid [C, X, Y, Z], xyz [..., 3] -> (value [..., C], grad [..., C, 3])."""
    xyz_min, xyz_max = _bounds_like(xyz, xyz_min, xyz_max)
    C = grid.shape[0]
    val, grad = _Trilinear.apply(grid, xyz.reshape(-1, 3).contiguous(), xyz_min, xyz_max, True)
    return val.reshape(*xyz.shape[:-1], C), grad.reshape(*xyz.shape[:-1], C, 3)


# ---------------------------------------------------------------------------
# the rest of the grid stack (plain PyTorch)


def abs_one_sided(x: torch.Tensor) -> torch.Tensor:
    """|x| whose derivative at exactly 0 is +1, as `jax.numpy.abs` has it
    (`torch.abs` gives 0 there). It matters where a term starts at exact zero:
    the zero-initialised k0 grid's total variation and the deformation
    priors, whose first gradients the reference's optimizer does see."""
    return torch.where(x >= 0, x, -x)


def resize_trilinear(grid: torch.Tensor, new_size) -> torch.Tensor:
    """Trilinear grid resize [C, X, Y, Z] -> [C, *new_size] (align_corners=True)."""
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
    """||smooth(grad).detach() - grad||^2 with the separable 1-D factor [k]
    of the smoothing kernel."""
    if smooth_kernel.ndim != 1:
        raise NotImplementedError("only the separable 1-D smoothing kernel is ported")
    smoothed = conv3d_separable_replicate(sdf_grad, smooth_kernel).detach()
    err = (smoothed - sdf_grad) ** 2
    if mask is not None:
        err = err * mask.to(err.dtype)
        return err.sum() / torch.clamp(mask.sum() * 3.0, min=1.0)
    return err.mean()
