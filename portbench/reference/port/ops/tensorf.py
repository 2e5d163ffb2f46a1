"""TensoRF vector-matrix decomposed grid (VM factorization).

Port of `poseprobe_tpu/ops/tensorf.py`: the field is a sum of plane x vector
outer products with an optional feature-mixing matrix ``f_vec``. A query is
three bilinear plane lookups, three linear vector lookups and one matmul.

The lookups are gathers on the same clamped indices as the reference, not
`F.grid_sample`, so that the gradient at the clamp is the reference's: the
coordinate clip splits its cotangent at a tie with a bound (`geometry.clip`,
as `jnp.clip` does), where `torch.clamp` would pass all of it. Every index is
a device tensor, so a training step through these lookups stays graph-safe.
"""
from __future__ import annotations

import math

import torch

from ..core.geometry import clip


def init_tensorf_params(generator: torch.Generator, channels: int, world_size, n_comp: int,
                        device="cuda") -> dict:
    """Planes and vectors ~ N(0, 0.1^2), R = `n_comp` components each; with
    more than one channel the mixing matrix ``f_vec`` [3R, C] ~ U(-b, b),
    b = sqrt(1 / R). Drawn from `generator` (on its device), then moved to
    `device`."""
    X, Y, Z = world_size
    R = n_comp
    gdev = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=gdev) * 0.1

    params = {
        "xy_plane": normal(R, X, Y),
        "xz_plane": normal(R, X, Z),
        "yz_plane": normal(R, Y, Z),
        "x_vec": normal(R, X),
        "y_vec": normal(R, Y),
        "z_vec": normal(R, Z),
    }
    if channels > 1:
        bound = math.sqrt(1.0 / R)
        u = torch.rand((3 * R, channels), generator=generator, device=gdev)
        params["f_vec"] = u * (2.0 * bound) - bound
    return {k: v.to(device=device, dtype=torch.float32) for k, v in params.items()}


def _axis(u: torch.Tensor, A: int):
    """Index coordinate on an axis of A cells: (lower index [N] int64, its
    weight [N]) from u in [0, 1], clipped to the axis with the reference's
    gradient at the ends."""
    ia = clip(u * (A - 1), 0.0, A - 1.0)
    a0 = torch.clamp(torch.floor(ia), 0, A - 2).to(torch.int64)
    return a0, ia - a0.to(ia.dtype)


def _bilerp_plane(plane: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """plane [R, A, B]; u, v [N] in [0, 1] -> [N, R] (align_corners=True)."""
    R, A, B = plane.shape
    a0, wa = _axis(u, A)
    b0, wb = _axis(v, B)
    flat = plane.reshape(R, A * B)
    base = a0 * B + b0

    def at(off):
        return flat.index_select(1, base + off)        # [R, N]

    top = at(0) * (1 - wb) + at(1) * wb
    bot = at(B) * (1 - wb) + at(B + 1) * wb
    return (top * (1 - wa) + bot * wa).t()


def _lerp_vec(vec: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """vec [R, A]; u [N] in [0, 1] -> [N, R]."""
    a0, wa = _axis(u, vec.shape[1])
    return (vec.index_select(1, a0) * (1 - wa) + vec.index_select(1, a0 + 1) * wa).t()


def tensorf_sample(params: dict, xyz: torch.Tensor, xyz_min, xyz_max) -> torch.Tensor:
    """Query world points [..., 3] -> [..., C] (or [...] without ``f_vec``)."""
    shape = xyz.shape[:-1]
    pts = xyz.reshape(-1, 3)
    u = (pts - xyz_min) / (xyz_max - xyz_min)
    ux, uy, uz = u[:, 0], u[:, 1], u[:, 2]
    xy = _bilerp_plane(params["xy_plane"], ux, uy)
    xz = _bilerp_plane(params["xz_plane"], ux, uz)
    yz = _bilerp_plane(params["yz_plane"], uy, uz)
    xv = _lerp_vec(params["x_vec"], ux)
    yv = _lerp_vec(params["y_vec"], uy)
    zv = _lerp_vec(params["z_vec"], uz)
    if "f_vec" in params:
        feat = torch.cat([xy * zv, xz * yv, yz * xv], dim=-1)       # [N, 3R]
        return (feat @ params["f_vec"]).reshape(*shape, -1)
    val = (xy * zv).sum(-1) + (xz * yv).sum(-1) + (yz * xv).sum(-1)
    return val.reshape(shape)


def tensorf_to_dense(params: dict) -> torch.Tensor:
    """Expand to a dense grid [C, X, Y, Z]."""
    if "f_vec" in params:
        feat = torch.cat([
            torch.einsum("rxy,rz->rxyz", params["xy_plane"], params["z_vec"]),
            torch.einsum("rxz,ry->rxyz", params["xz_plane"], params["y_vec"]),
            torch.einsum("ryz,rx->rxyz", params["yz_plane"], params["x_vec"]),
        ])
        return torch.einsum("rxyz,rc->cxyz", feat, params["f_vec"])
    grid = (torch.einsum("rxy,rz->xyz", params["xy_plane"], params["z_vec"])
            + torch.einsum("rxz,ry->xyz", params["xz_plane"], params["y_vec"])
            + torch.einsum("ryz,rx->xyz", params["yz_plane"], params["x_vec"]))
    return grid[None]


def tensorf_total_variation(params: dict) -> torch.Tensor:
    """Smooth-L1 TV over the planes and vectors along each of their axes, as
    a loss."""

    def sl1(a, b):
        d = a - b
        ad = d.abs()
        return torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5).sum()

    loss = 0.0
    for k in ("xy_plane", "xz_plane", "yz_plane"):
        p = params[k]
        loss = loss + sl1(p[:, 1:], p[:, :-1]) + sl1(p[:, :, 1:], p[:, :, :-1])
    for k in ("x_vec", "y_vec", "z_vec"):
        p = params[k]
        loss = loss + sl1(p[:, 1:], p[:, :-1])
    return loss / 6.0


def tensorf_resize(params: dict, new_world_size) -> dict:
    """Bilinear-resize the planes and vectors to a new world size: each goes
    through `grid.resize_trilinear` as a [C, A, B, 1] grid."""
    from .grid import resize_trilinear

    X, Y, Z = new_world_size

    def resize_plane(p, a, b):
        return resize_trilinear(p[..., None], (a, b, 1))[..., 0]

    out = dict(params)
    out["xy_plane"] = resize_plane(params["xy_plane"], X, Y)
    out["xz_plane"] = resize_plane(params["xz_plane"], X, Z)
    out["yz_plane"] = resize_plane(params["yz_plane"], Y, Z)
    out["x_vec"] = resize_plane(params["x_vec"][:, :, None], X, 1)[:, :, 0]
    out["y_vec"] = resize_plane(params["y_vec"][:, :, None], Y, 1)[:, :, 0]
    out["z_vec"] = resize_plane(params["z_vec"][:, :, None], Z, 1)[:, :, 0]
    return out


# ------------------------------------------------------------------ MaskGrid
# The free-space cache of the reference's module; no training path calls it.

def make_mask_grid(sdf_grid: torch.Tensor, xyz_min, xyz_max, thres: float = 1e9) -> dict:
    """Free-space cache from an SDF grid [1, X, Y, Z] and its box."""
    dev = sdf_grid.device
    return {
        "sdf": sdf_grid,
        "xyz_min": torch.as_tensor(xyz_min, dtype=torch.float32, device=dev),
        "xyz_max": torch.as_tensor(xyz_max, dtype=torch.float32, device=dev),
        "thres": float(thres),
    }


def mask_grid_lookup(mask: dict, xyz: torch.Tensor) -> torch.Tensor:
    """True where the cached SDF, trilinearly sampled at xyz [..., 3], is below
    the threshold (occupied or unknown space)."""
    from .grid import trilinear_sample

    sdf = trilinear_sample(mask["sdf"], xyz, mask["xyz_min"], mask["xyz_max"])[..., 0]
    return sdf < mask["thres"]
