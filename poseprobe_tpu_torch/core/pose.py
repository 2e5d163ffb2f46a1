"""Camera pose ([..., 3, 4] = [R|t] world->camera) operations.

Port of `poseprobe_tpu/core/pose.py` (the slice's subset).
"""
from __future__ import annotations

import torch

from .graphsafe import const


def make(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation and [..., 3] translation -> [..., 3, 4] pose."""
    return torch.cat([R, t[..., None]], dim=-1)


def invert(pose: torch.Tensor) -> torch.Tensor:
    """Invert a rigid pose without a matrix inverse (R is orthonormal)."""
    R, t = pose[..., :3], pose[..., 3:]
    R_inv = R.transpose(-2, -1)
    return make(R_inv, (-R_inv @ t)[..., 0])


def compose_pair(pose_a: torch.Tensor, pose_b: torch.Tensor) -> torch.Tensor:
    """pose_new(x) = pose_b o pose_a(x)."""
    R_a, t_a = pose_a[..., :3], pose_a[..., 3:]
    R_b, t_b = pose_b[..., :3], pose_b[..., 3:]
    return make(R_b @ R_a, (R_b @ t_a + t_b)[..., 0])


def compose(pose_list) -> torch.Tensor:
    """pose_new(x) = poseN o ... o pose2 o pose1(x)."""
    pose_new = pose_list[0]
    for pose in pose_list[1:]:
        pose_new = compose_pair(pose_new, pose)
    return pose_new


def angle_to_rotation_matrix(a: torch.Tensor, axis: str) -> torch.Tensor:
    """[...] Euler angles about `axis` ("X", "Y" or "Z") -> [..., 3, 3] rotations."""
    roll = dict(X=1, Y=2, Z=0)[axis]
    zeros, ones = torch.zeros_like(a), torch.ones_like(a)
    M = torch.stack([torch.stack([torch.cos(a), -torch.sin(a), zeros], dim=-1),
                     torch.stack([torch.sin(a), torch.cos(a), zeros], dim=-1),
                     torch.stack([zeros, zeros, ones], dim=-1)], dim=-2)
    return torch.roll(M, shifts=(roll, roll), dims=(-2, -1))


def pad(pose: torch.Tensor) -> torch.Tensor:
    """[..., 3, 4] -> [..., 4, 4] with homogeneous bottom row."""
    bottom = const((0.0, 0.0, 0.0, 1.0), pose.dtype, pose.device).expand(pose[..., :1, :4].shape)
    return torch.cat([pose[..., :3, :4], bottom], dim=-2)


def invert_4x4(mat: torch.Tensor) -> torch.Tensor:
    """Invert a [..., 4, 4] rigid transform via the transpose trick."""
    R, t = mat[..., :3, :3], mat[..., :3, 3:]
    R_inv = R.transpose(-2, -1)
    return pad(torch.cat([R_inv, -R_inv @ t], dim=-1))


def to_hom(X: torch.Tensor) -> torch.Tensor:
    """Append a 1 to the last axis."""
    return torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)


def world2cam(X: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """Transform world points by a w2c pose. X: [..., N, 3], pose: [..., 3, 4]."""
    return to_hom(X) @ pose.transpose(-2, -1)


def cam2world(X: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """Transform camera-frame points to world by inverting the w2c pose."""
    return to_hom(X) @ invert(pose).transpose(-2, -1)


def cam2img(X: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    return X @ K.transpose(-2, -1)


def img2cam(X: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    return X @ inv3x3(K).transpose(-2, -1)


def inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Inverse of [..., 3, 3] matrices by the adjugate: elementwise work only,
    where `torch.linalg.inv` checks its result on the host."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A, B, C = e * i - f * h, f * g - d * i, d * h - e * g
    adj = torch.stack([torch.stack([A, c * h - b * i, b * f - c * e], -1),
                       torch.stack([B, a * i - c * g, c * d - a * f], -1),
                       torch.stack([C, b * g - a * h, a * e - b * d], -1)], -2)
    return adj / (a * A + b * B + c * C)[..., None, None]
