"""Pose-set alignment: procrustes, sim(3) Umeyama, pairwise small-set alignment.

The port's own copy of `poseprobe_tpu/core/align.py` (host numpy, no device
code): `procrustes_analysis`, the sim3 trajectory alignment
`align_ate_c2b_use_a2b`, the pairwise `prealign_w2c_small_camera_systems`
(robust for fewer than 10 views), `prealign_w2c_large_camera_systems`,
`backtrack_from_aligning_the_trajectory`, the R (deg) / t (x100) errors of
`evaluate_camera_alignment`, and the float64 mirrors of the pose composition
that the trainer's host pose events use (`current_pose_pnp_host`).

All of this runs at init, event and eval time, never in the hot loop, on host
numpy in float64 -- deliberately not on the device. The pose chains are tiny
(R1 @ R2^T traces, 4x4 inverses, sim3 composition), and a float32 or TF32
product injects ~1e-3 per-entry noise into them: degrees of rotation-angle
noise at the arccos boundary, enough to flip the pairwise-anchor argmin
between gauges from step to step. Metrics and the test-pose gauge mapping
must be exact; 6-10 poses cost microseconds on the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def _np64(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float64)


def _invert(P: np.ndarray) -> np.ndarray:
    """Rigid inverse of [N, 3, 4] (or [3, 4]) pose matrices."""
    R, t = P[..., :3, :3], P[..., :3, 3:]
    Rt = np.swapaxes(R, -2, -1)
    return np.concatenate([Rt, -Rt @ t], axis=-1)


def _pad(P: np.ndarray) -> np.ndarray:
    """[..., 3, 4] -> [..., 4, 4] homogeneous."""
    bottom = np.zeros(P.shape[:-2] + (1, 4), dtype=P.dtype)
    bottom[..., 0, 3] = 1.0
    return np.concatenate([P, bottom], axis=-2)


def se3_to_SE3_host(wu: np.ndarray) -> np.ndarray:
    """Host-float64 se(3) exp map, [N, 6] (w|u) -> [N, 3, 4].

    Mirror of `core/lie.se3_to_SE3` for metric paths: the device version runs
    in float32, which bakes its rounding into the pose matrix before any f64
    alignment sees it. No gradient flows here, so the exact closed form (with
    the small-angle series switch) is fine.
    """
    wu = _np64(wu)
    w, u = wu[:, :3], wu[:, 3:]
    theta = np.linalg.norm(w, axis=-1, keepdims=True)[..., None]  # [N,1,1]
    wx = np.zeros(w.shape[:-1] + (3, 3))
    wx[:, 0, 1], wx[:, 0, 2] = -w[:, 2], w[:, 1]
    wx[:, 1, 0], wx[:, 1, 2] = w[:, 2], -w[:, 0]
    wx[:, 2, 0], wx[:, 2, 1] = -w[:, 1], w[:, 0]
    wx2 = wx @ wx
    eye = np.eye(3)[None]
    small = theta < 1e-8
    with np.errstate(invalid="ignore", divide="ignore"):
        A = np.where(small, 1.0, np.sin(theta) / np.where(small, 1.0, theta))
        B = np.where(small, 0.5, (1 - np.cos(theta)) / np.where(small, 1.0, theta**2))
        C = np.where(small, 1.0 / 6.0,
                     (1 - A) / np.where(small, 1.0, theta**2))
    R = eye + A * wx + B * wx2
    V = eye + B * wx + C * wx2
    return np.concatenate([R, V @ u[..., None]], axis=-1)


def compose_pair_host(pose_a: np.ndarray, pose_b: np.ndarray) -> np.ndarray:
    """Host-f64 `pose_b o pose_a` for [N, 3, 4] w2c mats (core/pose.compose_pair)."""
    pose_a, pose_b = _np64(pose_a), _np64(pose_b)
    R = pose_b[..., :3, :3] @ pose_a[..., :3, :3]
    t = pose_b[..., :3, :3] @ pose_a[..., :3, 3:] + pose_b[..., :3, 3:]
    return np.concatenate([R, t], axis=-1)


def current_pose_pnp_host(se3_refine, poses_pnp, fix_first: bool = True) -> np.ndarray:
    """Host-f64 mirror of `models/pose_refine.current_pose_pnp` for metrics.

    current[i] = pnp[i] o refine[i], with pose 0 kept as the gauge anchor in
    PnP mode.
    """
    refined = compose_pair_host(se3_to_SE3_host(se3_refine), _np64(poses_pnp))
    if not fix_first:
        return refined
    out = refined.copy()
    out[0] = _np64(poses_pnp)[0]
    return out


@dataclasses.dataclass
class Sim3:
    """Similarity transform estimated from aligned camera sets.

    Applies as: aligned_c2w_t = R @ (s * t) + t0 (exact form depends on `type`).
    Fields are host float64 numpy.
    """

    R: np.ndarray  # [1, 3, 3]
    t: np.ndarray  # [1, 3, 1]
    s: float
    type: str = "traj_align"


def procrustes_analysis(X0, X1):
    """Similarity alignment of point sets [N, 3]: X1to0 = (X1-t1)/s1 @ R.T * s0 + t0."""
    X0, X1 = _np64(X0), _np64(X1)
    t0 = X0.mean(axis=0, keepdims=True)
    t1 = X1.mean(axis=0, keepdims=True)
    X0c, X1c = X0 - t0, X1 - t1
    s0 = np.sqrt((X0c**2).sum(axis=-1).mean())
    s1 = np.sqrt((X1c**2).sum(axis=-1).mean())
    U, _, Vt = np.linalg.svd((X0c / s0).T @ (X1c / s1))
    R = U @ Vt
    if np.linalg.det(R) < 0:
        R = R * np.array([1.0, 1.0, -1.0])[None, :]
    return dict(t0=t0[0], t1=t1[0], s0=s0, s1=s1, R=R)


def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale: bool = True):
    """Least-squares sim3: y ~= s * R @ x + t. x, y: [3, N]. Returns (R, t, s)."""
    x, y = _np64(x), _np64(y)
    mean_x = x.mean(axis=1, keepdims=True)
    mean_y = y.mean(axis=1, keepdims=True)
    n = x.shape[1]
    sigma_x = ((x - mean_x) ** 2).sum() / n
    cov_xy = (y - mean_y) @ (x - mean_x).T / n
    U, D, Vt = np.linalg.svd(cov_xy)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float(np.trace(np.diag(D) @ S) / sigma_x) if with_scale else 1.0
    t = mean_y - s * R @ mean_x
    return R, t[:, 0], s


def align_ate_c2b_use_a2b(traj_a_c2w, traj_b_c2w):
    """Align trajectory a to b with a sim3 over camera centers (method='sim3').

    traj_*: [N, 3, 4] c2w. Returns (aligned c2w [N, 4, 4] f64, Sim3).
    """
    traj_a_c2w, traj_b_c2w = _np64(traj_a_c2w), _np64(traj_b_c2w)
    ta = traj_a_c2w[:, :3, 3].T  # [3, N]
    tb = traj_b_c2w[:, :3, 3].T
    R, t, s = umeyama_alignment(ta, tb, with_scale=True)
    R_a = traj_a_c2w[:, :3, :3]
    t_a = traj_a_c2w[:, :3, 3:]
    R_aligned = R[None] @ R_a
    t_aligned = s * (R[None] @ t_a) + t.reshape(1, 3, 1)
    aligned = _pad(np.concatenate([R_aligned, t_aligned], axis=-1))
    sim3 = Sim3(R=R[None], t=t.reshape(1, 3, 1), s=s, type="traj_align")
    return aligned, sim3


def evaluate_camera_alignment(pose_aligned_w2c, pose_GT_w2c):
    """Rotation (deg) and translation (x100) errors between aligned and GT w2c poses.

    Host float64: a low-precision trace of R1 @ R2^T carries degrees of noise
    at small angles, and arccos amplifies it (see the module docstring).
    """
    pose_aligned_c2w = _invert(_np64(pose_aligned_w2c))
    pose_GT_c2w = _invert(_np64(pose_GT_w2c))
    R_aligned, t_aligned = pose_aligned_c2w[..., :3], pose_aligned_c2w[..., 3]
    R_GT, t_GT = pose_GT_c2w[..., :3], pose_GT_c2w[..., 3]
    # theta = 2 asin(||R1 - R2||_F / (2 sqrt 2)): identical to
    # acos((tr - 1)/2) but exact near 0, where the
    # acos form floors at ~1e-8 rad in f64 (clip eats sub-resolution angles;
    # synthetic PnP recovers rotations to machine precision, measured 0.0 deg).
    fro = np.linalg.norm(R_aligned - R_GT, axis=(-2, -1))
    R_error = np.degrees(2.0 * np.arcsin(np.clip(fro / (2.0 * np.sqrt(2.0)), 0.0, 1.0)))
    t_error = np.linalg.norm(t_aligned - t_GT, axis=-1) * 100.0
    return dict(R=R_error, t=t_error)


def prealign_w2c_large_camera_systems(pose_w2c, pose_GT_w2c):
    """Sim3 trajectory alignment; identity fallback if SVD fails."""
    pose_c2w = _invert(_np64(pose_w2c))
    pose_GT_c2w = _invert(_np64(pose_GT_w2c))
    try:
        aligned_c2w, sim3 = align_ate_c2b_use_a2b(pose_c2w, pose_GT_c2w)
        pose_aligned_w2c = _invert(aligned_c2w[:, :3])
    except Exception:
        pose_aligned_w2c = _np64(pose_w2c)
        sim3 = Sim3(R=np.eye(3)[None], t=np.zeros((1, 3, 1)), s=1.0)
    return pose_aligned_w2c, sim3


def _alignment_function(poses_c2w_from: np.ndarray, poses_c2w_to: np.ndarray,
                        idx_a: int, idx_b: int):
    """Scale by one pair's baseline, then align to the first pose of the pair."""
    dist_from = np.linalg.norm(poses_c2w_from[idx_a, :3, 3] - poses_c2w_from[idx_b, :3, 3])
    dist_to = np.linalg.norm(poses_c2w_to[idx_a, :3, 3] - poses_c2w_to[idx_b, :3, 3])
    scale = dist_to / (dist_from + 1e-12)
    scaled = poses_c2w_from.copy()
    scaled[:, :3, 3] *= scale
    transformation = poses_c2w_to[idx_a] @ np.linalg.inv(scaled[idx_a])
    aligned_c2w = transformation[None] @ scaled
    aligned_w2c = _invert(aligned_c2w[:, :3])
    sim3 = Sim3(R=transformation[:3, :3][None], t=transformation[:3, 3].reshape(1, 3, 1),
                s=float(scale))
    return aligned_w2c, sim3


def prealign_w2c_small_camera_systems(pose_w2c, pose_GT_w2c):
    """Try every pose pair as the alignment anchor; keep the lowest R*t error.

    Robust replacement for procrustes when there are fewer than 10 views.
    """
    pose_c2w = _pad(_invert(_np64(pose_w2c)))
    pose_GT_c2w = _pad(_invert(_np64(pose_GT_w2c)))
    B = pose_c2w.shape[0]
    best = None
    for pair_id_0 in range(min(B, 10)):
        for pair_id_1 in range(min(B, 10)):
            if pair_id_0 == pair_id_1:
                continue
            aligned_w2c, sim3 = _alignment_function(pose_c2w, pose_GT_c2w,
                                                    pair_id_0, pair_id_1)
            err = evaluate_camera_alignment(aligned_w2c, pose_GT_w2c)
            score = float(err["t"].mean()) * float(err["R"].mean())
            if best is None or score < best[0]:
                best = (score, aligned_w2c, sim3)
    return best[1], best[2]


def backtrack_from_aligning_the_trajectory(pose_GT_w2c, sim3: Sim3) -> np.ndarray:
    """Map GT test w2c poses into the optimized coordinate system (inverse sim3).

    Returns numpy float32 [N, 3, 4]: the caller moves it to the device it
    renders on.
    """
    pose_GT_c2w = _invert(_np64(pose_GT_w2c))
    R = _np64(sim3.R)
    R_T = np.swapaxes(R, -2, -1)
    R_aligned = R_T @ pose_GT_c2w[:, :3, :3]
    t_aligned = (R_T / sim3.s) @ (pose_GT_c2w[:, :3, 3:4] - _np64(sim3.t))
    aligned_c2w = np.concatenate([R_aligned, t_aligned], axis=-1)
    return _invert(aligned_c2w).astype(np.float32)


def apply_sim3_points(pts: np.ndarray, sim3: Sim3) -> np.ndarray:
    """Map WORLD points from the optimized gauge into the GT gauge.

    The sim3 returned by the prealign functions maps optimized c2w poses to
    GT c2w as `c' = R @ (s * c) + t` (camera centers transform like world
    points under a rigid-scene gauge change), so the same map carries mesh
    vertices into GT units for chamfer evaluation. Host float64.
    """
    pts = _np64(pts)
    R = _np64(sim3.R)[0]
    t = _np64(sim3.t).reshape(1, 3)
    return (sim3.s * pts) @ R.T + t
