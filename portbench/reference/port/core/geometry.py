"""Batched projection / backprojection used by the corres, depth and
reprojection losses.

Port of `poseprobe_tpu/core/geometry.py` (the ported slices' subset).
"""
from __future__ import annotations

import torch

from .pose import inv3x3


def to_homogeneous(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def from_homogeneous(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x[..., :-1] / (x[..., -1:] + eps)


def batch_project_to_other_img(kpi, di, Ki, Kj, T_itoj, return_depth: bool = False):
    """Project pixels of image i (with depth di) into image j.

    kpi: [..., N, 2], di: [..., N], Ki/Kj: [..., 3, 3], T_itoj: [..., 4, 4].
    """
    if di.ndim == kpi.ndim:
        di = di[..., 0]
    kpi_3d_i = to_homogeneous(kpi) @ inv3x3(Ki).transpose(-1, -2)
    kpi_3d_i = kpi_3d_i * di[..., None]
    kpi_3d_j = from_homogeneous(to_homogeneous(kpi_3d_i) @ T_itoj.transpose(-1, -2))
    kpi_j = from_homogeneous(kpi_3d_j @ Kj.transpose(-1, -2))
    if return_depth:
        return kpi_j, kpi_3d_j[..., -1]
    return kpi_j


def batch_backproject_to_3d(kpi, di, Ki, T_itoj):
    """Backproject pixels [..., N, 2] with depths [..., N] into frame j."""
    kpi_3d_i = to_homogeneous(kpi) @ inv3x3(Ki).transpose(-1, -2)
    kpi_3d_i = kpi_3d_i * di[..., None]
    return from_homogeneous(to_homogeneous(kpi_3d_i) @ T_itoj.transpose(-1, -2))


def batch_project(kpi_3d_i, T_itoj, Kj, return_depth: bool = False):
    """Project 3D points [..., N, 3] in frame i to pixels of image j."""
    kpi_3d_in_j = from_homogeneous(to_homogeneous(kpi_3d_i) @ T_itoj.transpose(-1, -2))
    kpi_2d_in_j = kpi_3d_in_j @ Kj.transpose(-1, -2)
    if return_depth:
        return from_homogeneous(kpi_2d_in_j), kpi_3d_in_j[..., -1]
    return from_homogeneous(kpi_2d_in_j)


def project_to_cam(points: torch.Tensor, camera_mat: torch.Tensor) -> torch.Tensor:
    """Camera-frame points [..., N, 3] -> pixel coords [..., N, 2] (perspective divide)."""
    xy = points @ camera_mat.transpose(-1, -2)
    return xy[..., :2] / (xy[..., 2:] + 1e-12)


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """`jnp.clip` with its gradient: at a tie with a bound half the cotangent
    passes (`torch.clamp` passes all of it)."""
    return torch.minimum(torch.maximum(x, torch.full_like(x, lo)), torch.full_like(x, hi))


def bilinear_image_sample(image: torch.Tensor, pixels: torch.Tensor) -> torch.Tensor:
    """Bilinearly sample an [H, W, C] image at [N, 2] (x, y) pixel coordinates
    (`F.grid_sample`'s align_corners=True on the pixel lattice, border-clamped).
    Differentiable w.r.t. the pixels; a point exactly on the border takes the
    reference's half gradient there (`clip`)."""
    H, W = image.shape[0], image.shape[1]
    x = clip(pixels[..., 0], 0.0, W - 1.0)
    y = clip(pixels[..., 1], 0.0, H - 1.0)
    x0 = torch.clamp(torch.floor(x), 0, W - 2).to(torch.int64)
    y0 = torch.clamp(torch.floor(y), 0, H - 2).to(torch.int64)
    wx = (x - x0.to(x.dtype))[..., None]
    wy = (y - y0.to(y.dtype))[..., None]
    flat = image.reshape(H * W, -1)

    def at(yi, xi):     # index_select: graph-safe, and its backward adds by index
        return flat.index_select(0, (yi * W + xi).reshape(-1)).reshape(xi.shape + flat.shape[1:])

    top = at(y0, x0) * (1 - wx) + at(y0, x0 + 1) * wx
    bot = at(y0 + 1, x0) * (1 - wx) + at(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def point_to_ray_distance(ray_origins: torch.Tensor, ray_directions: torch.Tensor,
                          point: torch.Tensor) -> torch.Tensor:
    """Distance of a point to rays; rays that point away from it use the
    distance to their origin."""
    v = point - ray_origins
    t = torch.sum(v * ray_directions, dim=-1)
    dist_to_origin = torch.linalg.norm(v, dim=-1)
    p_proj = ray_origins + t[..., None] * ray_directions
    dist_to_line = torch.linalg.norm(point - p_proj, dim=-1)
    return torch.where(t < 0, dist_to_origin, dist_to_line)
