"""Essential-matrix relative-pose guard for the PnP chain.

The port's own copy of `poseprobe_tpu/pose_init/relpose.py` (numpy, optional
OpenCV; no device code): `essential_relative_pose`, `apply_essential_guard`.

PnP's 3D anchors come from casting the previous view's noisy match pixels onto
the probe SDF, so pixel noise becomes 3D anchor noise amplified by surface
slant, and the anchors sit on 1-2 near-planar cube faces, where a solve can
fit its own anchors at sub-pixel reprojection while being degrees wrong. The
2D-2D route avoids 3D anchor lifting: solve PnP as before; solve E on the
combined object + scene packs; if the two relative rotations disagree beyond
a gate and E has healthy support, keep E's rotation and refit the translation
over the PnP anchors at fixed R (trimmed Gauss-Newton on the 3-dof t).

The guard is default-off and experimental (`pnp_from_matches`'s
``essential_gate_deg``): under a dominant plane, as with the synthetic scene's
background wall, E estimation is itself two-fold ambiguous. Without `cv2`,
`essential_relative_pose` returns no estimate and the guard leaves the PnP
pose alone.
"""
from __future__ import annotations

import numpy as np

try:
    import cv2
    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False


def essential_relative_pose(packs, K: np.ndarray):
    """R_rel, t_dir (unit), inlier count from [M,5] packs (x_prev, y_prev,
    x_cur, y_cur, conf). Returns (None, None, 0) on failure.

    Convention: X_cur = R_rel @ X_prev + s * t_dir (cam frames), matching
    W2C_cur = [R_rel | s t_dir] ∘ W2C_prev.
    """
    if not _HAS_CV2:
        return None, None, 0
    pts = np.concatenate([np.asarray(p) for p in packs], axis=0)
    valid = pts[:, 4] > 0
    pts = pts[valid]
    if len(pts) < 12:
        return None, None, 0
    p_prev = pts[:, 0:2].astype(np.float64)
    p_cur = pts[:, 2:4].astype(np.float64)
    K64 = np.asarray(K, np.float64)
    E, mask = cv2.findEssentialMat(p_prev, p_cur, K64, method=cv2.RANSAC,
                                   prob=0.999, threshold=1.5)
    if E is None or E.shape != (3, 3):
        return None, None, 0
    n_in, R, t, mask2 = cv2.recoverPose(E, p_prev, p_cur, K64, mask=mask)
    if n_in < 10:
        return None, None, 0
    return np.asarray(R), np.asarray(t).reshape(3), int(n_in)


def _refit_translation(R_fix: np.ndarray, t0: np.ndarray, world_pts, img_pts,
                       K: np.ndarray, iters: int = 8) -> np.ndarray:
    """Trimmed GN on t (R fixed): minimize reprojection of the anchors."""
    t = np.asarray(t0, np.float64).copy()
    K64 = np.asarray(K, np.float64)
    X = np.asarray(world_pts, np.float64)
    px = np.asarray(img_pts, np.float64)
    for _ in range(iters):
        pc = X @ R_fix.T + t
        z = np.clip(pc[:, 2], 1e-9, None)
        proj = (pc[:, :2] / z[:, None]) @ K64[:2, :2].T + K64[:2, 2]
        r = (proj - px)
        e = np.linalg.norm(r, axis=1)
        keep = e < max(3.0 * np.median(e), 1.0)
        if keep.sum() < 6:
            break
        # d proj / d t for pinhole: [[fx/z, 0, -fx x/z^2], [0, fy/z, -fy y/z^2]]
        fx, fy = K64[0, 0], K64[1, 1]
        zk = z[keep]
        J = np.zeros((keep.sum(), 2, 3))
        J[:, 0, 0] = fx / zk
        J[:, 0, 2] = -fx * pc[keep, 0] / zk ** 2
        J[:, 1, 1] = fy / zk
        J[:, 1, 2] = -fy * pc[keep, 1] / zk ** 2
        Jf = J.reshape(-1, 3)
        rf = r[keep].reshape(-1)
        try:
            dt = np.linalg.solve(Jf.T @ Jf + 1e-9 * np.eye(3), -Jf.T @ rf)
        except np.linalg.LinAlgError:
            break
        t = t + dt
        if np.linalg.norm(dt) < 1e-10:
            break
    return t


def rotation_angle_deg(Ra: np.ndarray, Rb: np.ndarray) -> float:
    c = (np.trace(Ra @ Rb.T) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def apply_essential_guard(pose_pnp: np.ndarray, prev_pose_w2c: np.ndarray,
                          packs, K: np.ndarray, world_pts, img_pts,
                          gate_deg: float = 2.0, min_inliers: int = 30):
    """Replace PnP's rotation with the essential-matrix rotation when they
    disagree beyond `gate_deg` (t refit at fixed R over the PnP anchors).

    Returns (pose [3,4], info dict). `world_pts`/`img_pts`: the valid PnP
    anchor set (for the t refit); pass None to skip the guard.
    """
    info = {"applied": False, "disagreement_deg": float("nan"), "e_inliers": 0}
    if world_pts is None or len(world_pts) < 6:
        return pose_pnp, info
    R_rel, t_dir, n_in = essential_relative_pose(packs, K)
    if R_rel is None or n_in < min_inliers:
        return pose_pnp, info
    R_prev = np.asarray(prev_pose_w2c[:, :3], np.float64)
    R_e = R_rel @ R_prev
    dis = rotation_angle_deg(np.asarray(pose_pnp[:, :3], np.float64), R_e)
    info.update(disagreement_deg=dis, e_inliers=n_in)
    if dis <= gate_deg:
        return pose_pnp, info
    t_e = _refit_translation(R_e, np.asarray(pose_pnp[:, 3], np.float64),
                             world_pts, img_pts, K)
    pose_e = np.concatenate([R_e, t_e[:, None]], axis=1).astype(np.float32)

    # accept whichever pose reprojects the anchors better on a HOLDOUT split
    # (the anchors are noisy, but both candidates face the same noise floor;
    # the degenerate PnP solve overfits its own anchors yet generalizes
    # worse across the split)
    def holdout_med(pose):
        errs = []
        for sl in (slice(0, None, 2), slice(1, None, 2)):
            pc = np.asarray(world_pts)[sl] @ np.asarray(pose[:, :3], np.float64).T \
                + np.asarray(pose[:, 3], np.float64)
            z = np.clip(pc[:, 2], 1e-9, None)
            proj = (pc[:, :2] / z[:, None]) @ np.asarray(K, np.float64)[:2, :2].T \
                + np.asarray(K, np.float64)[:2, 2]
            errs.append(np.median(np.linalg.norm(
                proj - np.asarray(img_pts)[sl], axis=1)))
        return float(max(errs))

    med_pnp, med_e = holdout_med(pose_pnp), holdout_med(pose_e)
    info["med_pnp_px"], info["med_e_px"] = med_pnp, med_e
    # the essential rotation is geometrically better-grounded: prefer it
    # unless it clearly reprojects worse (x1.5) than the PnP pose
    if med_e <= 1.5 * med_pnp:
        info["applied"] = True
        return pose_e, info
    return pose_pnp, info
