"""Novel-view video synthesis: camera paths, rendering and encoding.

Port of `poseprobe_tpu/eval/video.py`: the oscillation path around an anchor
pose, the LLFF-style spiral around the training trajectory, slerp and
B-spline interpolation between keyframes (scipy), the depth colouring, and
`render_video`, which renders a pose path through `evaluator.render_full`
(on the params' device) and encodes it. Depth is coloured with the port's own
copy of the turbo map (`eval/turbo.py`), bit-equal to matplotlib's. Videos
are written by imageio where it is installed (mp4, else a GIF, as the
reference does); without imageio the frames are written as a numbered PNG
sequence by the port's PNG writer.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..core import pose as pose_ops
from ..data.png import write_png
from . import evaluator, turbo


def oscillation_poses(pose_anchor_w2c, n: int = 60, scale: float = 1.0) -> torch.Tensor:
    """Small circular oscillations around an anchor w2c pose [3, 4] -> [n, 3, 4]."""
    anchor = torch.as_tensor(pose_anchor_w2c, dtype=torch.float32)
    theta = torch.arange(n, dtype=torch.float32) / n * 2 * np.pi
    R_x = pose_ops.angle_to_rotation_matrix(torch.arcsin(torch.sin(theta) * 0.1), "X")
    R_y = pose_ops.angle_to_rotation_matrix(torch.arcsin(torch.cos(theta) * 0.1), "Y")
    pose_rot = pose_ops.make(R_y @ R_x, torch.zeros((n, 3)))
    eye = torch.eye(3)
    pose_shift = pose_ops.make(eye, torch.tensor([0.0, 0.0, -4.0 * scale]))
    pose_shift2 = pose_ops.make(eye, torch.tensor([0.0, 0.0, 3.8 * scale]))
    pose_oscil = pose_ops.compose([pose_shift, pose_rot, pose_shift2])
    return pose_ops.compose([pose_oscil, anchor[None]])


def spiral_poses_from_trajectory(poses_c2w: np.ndarray, n: int = 60, n_rots: float = 2.0,
                                 zrate: float = 0.5, rad_scale: float = 1.0) -> np.ndarray:
    """LLFF-style spiral around the average training camera. poses_c2w:
    [B, 3, 4]. Returns [n, 3, 4] c2w (float32)."""
    center = poses_c2w[:, :3, 3].mean(0)
    z_avg = poses_c2w[:, :3, 2].mean(0)
    z_avg = z_avg / np.linalg.norm(z_avg)
    up = -poses_c2w[:, :3, 1].mean(0)
    rads = np.abs(poses_c2w[:, :3, 3] - center).max(0) * rad_scale + 1e-6
    out = []
    for theta in np.linspace(0.0, 2.0 * np.pi * n_rots, n, endpoint=False):
        c = center + rads * np.array([np.cos(theta), -np.sin(theta), -np.sin(theta * zrate)])
        fwd = z_avg + 0.1 * (center - c)
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        true_up = np.cross(fwd, right)
        R = np.stack([right, true_up, fwd], axis=1)
        out.append(np.concatenate([R, c[:, None]], axis=1))
    return np.stack(out).astype(np.float32)


def interp_poses_slerp(c2ws: np.ndarray, n_views: int) -> np.ndarray:
    """Slerp rotations and linear translations between keyframe c2w poses:
    [K, 3, 4] -> [n, 3, 4]."""
    from scipy.spatial.transform import Rotation, Slerp

    times = np.linspace(0, 1, c2ws.shape[0])
    slerp = Slerp(times, Rotation.from_matrix(c2ws[:, :3, :3]))
    tt = np.linspace(0, 1, n_views)
    rots = slerp(tt).as_matrix().astype(np.float32)
    trans = np.stack([np.interp(tt, times, c2ws[:, i, 3]) for i in range(3)], -1)
    return np.concatenate([rots, trans[:, :, None].astype(np.float32)], axis=2)


def interp_poses_bspline(c2ws: np.ndarray, n_views: int, degree: int = 2) -> np.ndarray:
    """B-spline translations and slerp rotations between keyframe c2w poses."""
    from scipy.interpolate import splev, splprep
    from scipy.spatial.transform import Rotation, Slerp

    pts = c2ws[:, :3, 3]
    k = min(degree, len(pts) - 1)
    tck, _ = splprep(pts.T, k=k, s=0)
    u = np.linspace(0, 1, n_views)
    trans = np.stack(splev(u, tck), -1).astype(np.float32)
    times = np.linspace(0, 1, c2ws.shape[0])
    slerp = Slerp(times, Rotation.from_matrix(c2ws[:, :3, :3]))
    rots = slerp(u).as_matrix().astype(np.float32)
    return np.concatenate([rots, trans[:, :, None]], axis=2)


def colorize_depth(depth: np.ndarray, d_range=None) -> np.ndarray:
    """Depth -> [H, W, 3] uint8 through the turbo map, over [min, max] of the
    depth or over `d_range`."""
    d = np.asarray(depth).squeeze()
    lo, hi = (d.min(), d.max()) if d_range is None else d_range
    return turbo.apply(np.clip((d - lo) / max(hi - lo, 1e-8), 0, 1))


def render_video(scene_params, scene_cfg, poses_w2c, K, H, W, depth_range, out_path: str,
                 fps: int = 10, depth_out_path: str | None = None) -> str:
    """Render a pose path [n, 3, 4] and encode the rgb (and optionally the
    coloured depth) frames. Returns the path written: `out_path`, the GIF
    beside it when imageio has no mp4 backend, or, without imageio, the
    directory of numbered PNG frames beside it."""
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    rgb_frames, depth_frames = [], []
    for i in range(len(poses_w2c)):
        out = evaluator.render_full(scene_params, scene_cfg, poses_w2c[i], K, H, W, depth_range)
        rgb_frames.append((np.clip(out["rgb"].cpu().numpy(), 0, 1) * 255).astype(np.uint8))
        depth_frames.append(colorize_depth(out["depth"].cpu().numpy(), depth_range))
    out_path = _write_animation(out_path, rgb_frames, fps)
    if depth_out_path:
        _write_animation(depth_out_path, depth_frames, fps)
    return out_path


def _write_animation(out_path: str, frames: list, fps: int) -> str:
    """imageio's mimwrite, with a GIF where it has no mp4 backend; without
    imageio, frame_%04d.png files in ``<out_path without extension>_frames/``.
    Returns the path written."""
    try:
        import imageio
    except ImportError:
        frame_dir = os.path.splitext(out_path)[0] + "_frames"
        os.makedirs(frame_dir, exist_ok=True)
        for i, frame in enumerate(frames):
            write_png(os.path.join(frame_dir, f"frame_{i:04d}.png"), frame)
        print(f"[video] no imageio; wrote {len(frames)} PNG frames to {frame_dir}")
        return frame_dir
    try:
        imageio.mimwrite(out_path, frames, fps=fps)
        return out_path
    except (ValueError, ImportError):
        alt = os.path.splitext(out_path)[0] + ".gif"
        # pillow's GIF writer takes a per-frame duration (ms), not fps
        imageio.mimwrite(alt, frames, duration=1000.0 / fps, loop=0)
        print(f"[video] no mp4 backend; wrote {alt} instead")
        return alt
