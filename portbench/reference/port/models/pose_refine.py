"""Per-view SE(3) refinement parameters and pose composition.

Port of `poseprobe_tpu/models/pose_refine.py` (the slice's subset). Poses are
w2c [N, 3, 4].
"""
from __future__ import annotations

import torch

from ..core import lie, pose as pose_ops


def init_pose_params(n_train: int, device="cuda") -> dict:
    return {
        "se3_refine": torch.zeros((n_train, 6), dtype=torch.float32, device=device),
        "se3_align_refine": torch.zeros((1, 6), dtype=torch.float32, device=device),
    }


def make_pose_noise(generator: torch.Generator, n_train: int, camera_noise: float) -> torch.Tensor:
    """Synthetic pose perturbation [N, 3, 4]."""
    se3_noise = torch.randn((n_train, 6), generator=generator) * camera_noise
    return lie.se3_to_SE3(se3_noise)


def current_pose_pnp(pose_params: dict, poses_pnp: torch.Tensor,
                     fix_first: bool = True) -> torch.Tensor:
    """current[i] = pnp[i] o refine[i]; with `fix_first`, pose 0 stays the
    gauge anchor."""
    refined = pose_ops.compose_pair(lie.se3_to_SE3(pose_params["se3_refine"]), poses_pnp)
    if not fix_first:
        return refined
    keep_first = (torch.arange(poses_pnp.shape[0], device=poses_pnp.device) == 0)[:, None, None]
    return torch.where(keep_first, poses_pnp, refined)
