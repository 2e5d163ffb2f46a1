"""Camera rays.

Port of `poseprobe_tpu/core/rays.py` (the ported slices' subset). Scene
branch: rays are built by unprojecting homogeneous pixel coordinates through
K^-1 and a w2c pose. Object branch (`get_ray_dir`): unit rays through pixel
coordinate lists from a c2w pose.
"""
from __future__ import annotations

import torch

from . import pose as pose_ops


def get_rays(H: int, W: int, K: torch.Tensor, c2w: torch.Tensor, inverse_y: bool):
    """Per-pixel object-branch rays through pixel centres: (rays_o, rays_d),
    each [H, W, 3]; the directions are not normalised."""
    i, j = torch.meshgrid(torch.arange(W, dtype=torch.float32, device=K.device) + 0.5,
                          torch.arange(H, dtype=torch.float32, device=K.device) + 0.5, indexing="xy")
    x, y = (i - K[0][2]) / K[0][0], (j - K[1][2]) / K[1][1]
    if inverse_y:
        dirs = torch.stack([x, y, torch.ones_like(i)], -1)
    else:
        dirs = torch.stack([x, -y, -torch.ones_like(i)], -1)
    rays_d = torch.einsum("hwc,rc->hwr", dirs, c2w[:3, :3])
    return c2w[:3, 3].expand(rays_d.shape), rays_d


def get_ray_dir(points: torch.Tensor, K: torch.Tensor, c2w: torch.Tensor, inverse_y: bool,
                mode: str = "center"):
    """Rays through 2D pixel coords (the object branch's reprojection path).

    points: [B, N, 2]; K: [B, 3, 3]; c2w: [B, 3, 4]. Returns (rays_o, rays_d),
    each [B, N, 3], with unit-norm directions.
    """
    if mode == "center":
        points = points + 0.5
    px, py = points[..., 0], points[..., 1]
    x = (px - K[:, 0, None, 2]) / K[:, 0, None, 0]
    y = (py - K[:, 1, None, 2]) / K[:, 1, None, 1]
    if inverse_y:
        dirs = torch.stack([x, y, torch.ones_like(px)], -1)
    else:
        dirs = torch.stack([x, -y, -torch.ones_like(px)], -1)
    rays_d = torch.einsum("bnc,brc->bnr", dirs, c2w[:, :3, :3])
    rays_d = rays_d / (torch.linalg.norm(rays_d, dim=-1, keepdim=True) + 1e-12)
    rays_o = c2w[:, None, :3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def get_center_and_ray_at_pixels(pose_w2c: torch.Tensor, pixels: torch.Tensor,
                                 intr: torch.Tensor):
    """Rays at pixels [..., N, 2] (adds the +0.5 center): (centers, directions).

    Directions are not normalised; their norm turns depth into distance.
    """
    if pose_w2c.ndim == 2:
        pose_w2c = pose_w2c[None]
    if intr.ndim == 2:
        intr = intr[None]
    if pixels.ndim == 2:
        pixels = pixels.expand((pose_w2c.shape[0],) + pixels.shape)
    grid_3d = pose_ops.img2cam(pose_ops.to_hom(pixels + 0.5), intr)
    center_3d = torch.zeros_like(grid_3d)
    grid_3d = pose_ops.cam2world(grid_3d, pose_w2c)
    center_3d = pose_ops.cam2world(center_3d, pose_w2c)
    return center_3d, grid_3d - center_3d


def get_3d_points_from_depth(center: torch.Tensor, ray: torch.Tensor, depth: torch.Tensor,
                             multi_samples: bool = False) -> torch.Tensor:
    """x = c + d*v."""
    if multi_samples:
        center, ray = center[:, :, None], ray[:, :, None]
    return center + ray * depth
