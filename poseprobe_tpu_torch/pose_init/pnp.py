"""Host-side PnP-RANSAC pose initialisation against the object SDF.

Port of `poseprobe_tpu/pose_init/pnp.py`: matched pixels in the *previous*
view are cast as rays, the pose-probe SDF gives their 3D surface anchors
(`object_sdf.query_surface_points`, on the params' device), and PnP-RANSAC
recovers the new view's w2c pose from those 3D points and the matched pixels
in the new view.

The solve itself runs on the host in numpy float64, at init and at view
activation only -- off the hot path. With OpenCV it is
`cv2.solvePnPRansac` + `cv2.solvePnPRefineLM`; without it (OpenCV is an
optional dependency) the pure-numpy DLT RANSAC `_pnp_ransac_numpy` takes its
place, as in the reference. `pnp_path()` names the path in use.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import geometry, lie, pose as pose_ops, rays as rays_mod
from ..core.tree import tree_leaves
from ..models import object_sdf, scene_nerf

try:
    import cv2
    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False


def pnp_path() -> str:
    """Which solver `_solve_core` takes: "cv2" or "numpy"."""
    return "cv2" if _HAS_CV2 else "numpy"


def _device_of(params: dict) -> torch.device:
    return tree_leaves(params)[0].device


def _t32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)


def _surface_anchors(obj_params: dict, obj_cfg, coord_prev, K, prev_pose_w2c, inverse_y: bool,
                     near: float, far: float):
    """Probe-surface points under the previous view's match pixels:
    (pts [M, 3], valid [M] bool, ray origins [M, 3]) as numpy."""
    device = _device_of(obj_params)
    with torch.no_grad():
        c2w_prev = pose_ops.invert(_t32(prev_pose_w2c, device)[None])
        ro, rd = rays_mod.get_ray_dir(_t32(coord_prev, device)[None], _t32(K, device)[None], c2w_prev,
                                      inverse_y=inverse_y, mode="no_center")
        pts, valid, _ = object_sdf.query_surface_points(
            obj_params, obj_cfg, ro.reshape(-1, 3), rd.reshape(-1, 3), use_deform=False,
            near=near, far=far)
    return pts.cpu().numpy(), valid.cpu().numpy(), ro.reshape(-1, 3).cpu().numpy()


def _scene_depth_at(scene_params: dict, scene_cfg, pixels, K, pose_w2c, depth_range, progress: float,
                    use_fine: bool):
    """Scene-rendered depth at `pixels` of a view (deterministic sampling):
    (center [M, 3], ray [M, 3], depth [M]) as tensors on the params' device."""
    device = _device_of(scene_params)
    with torch.no_grad():
        center, ray = rays_mod.get_center_and_ray_at_pixels(
            _t32(pose_w2c, device)[None], _t32(pixels, device)[None], _t32(K, device)[None])
        rets = scene_nerf.render_rays(scene_params, scene_cfg, center, ray, depth_range,
                                      progress=progress, noise=None, compute_fine=use_fine)
        depth = rets["depth_fine" if (use_fine and "depth_fine" in rets) else "depth"][0, :, 0]
    return center[0], ray[0], depth


def pnp_from_matches(
    obj_params: dict,
    obj_cfg: object_sdf.ObjectConfig,
    match_pack: np.ndarray,     # [M, 5]: (x_prev, y_prev, x_cur, y_cur, conf)
    K: np.ndarray,              # [3, 3]
    prev_pose_w2c: np.ndarray,  # [3, 4]
    inverse_y: bool,
    near: float,
    far: float,
    extra_packs=None,           # additional [M, 5] packs for the E estimate
    essential_gate_deg: float = 0.0,
) -> np.ndarray:
    """Estimate the w2c pose [3, 4] of the current view. Returns the previous
    pose on failure.

    ``essential_gate_deg > 0`` (experimental, default off) cross-checks the
    PnP solve against the essential-matrix relative rotation over the match
    packs (`relpose.apply_essential_guard`); see relpose.py for why it hurts
    on plane-dominated scenes. PnP pose error at the synthetic protocol's
    scale is conditioning-limited, not outlier-limited: the probe spans ~25 px
    of a 64 px image, and a small angular constellation amplifies pixel noise
    into degrees.
    """
    match_pack = np.asarray(match_pack)
    coord_cur = match_pack[:, 2:4]
    conf = match_pack[:, 4]
    pts, valid, _ = _surface_anchors(obj_params, obj_cfg, match_pack[:, 0:2], K, prev_pose_w2c,
                                     inverse_y, near, far)
    valid = valid & (conf > 0)
    if valid.sum() < 6:
        return prev_pose_w2c.copy()
    world_pts = pts[valid].astype(np.float64)
    img_pts = coord_cur[valid].astype(np.float64)
    pose = solve_pnp(world_pts, img_pts, K, prev_pose_w2c)
    if essential_gate_deg > 0:
        from . import relpose

        packs = [match_pack] + list(extra_packs or [])
        pose, ginfo = relpose.apply_essential_guard(
            pose, np.asarray(prev_pose_w2c), packs, K, world_pts, img_pts,
            gate_deg=essential_gate_deg)
        if LAST_QUALITY is not None:
            LAST_QUALITY["essential_guard"] = ginfo
            if ginfo["applied"]:
                # the E rotation invalidates the PnP solve's self-reported
                # quality; recompute on the corrected pose
                LAST_QUALITY["med_reproj_px"] = _median_reproj_err(pose, world_pts, img_pts, K)
    return pose


def pnp_from_matches_scalefixed(
    obj_params: dict,
    obj_cfg: object_sdf.ObjectConfig,
    match_pack: np.ndarray,
    K: np.ndarray,
    prev_pose_w2c: np.ndarray,
    inverse_y: bool,
    near: float,
    far: float,
    scene_params: dict,
    scene_cfg,
    progress: float,
    use_fine: bool = False,
) -> np.ndarray:
    """Probe-geometry anchors, scene-gauge scale.

    The probe SDF gives sharp, reliable anchor geometry but in its own
    drifting gauge (the deform field absorbs scale), which injects
    per-activation translation error. Pure scene-depth anchors fail the other
    way: at activation time the rendered depth is too blurry for per-point
    anchors. This hybrid keeps the probe anchors but rescales their camera
    distances by one robust scalar -- the median ratio of scene-rendered depth
    to probe-anchor depth at the same matched pixels of the already-calibrated
    previous view.
    """
    match_pack = np.asarray(match_pack)
    coord_prev = match_pack[:, 0:2]
    coord_cur = match_pack[:, 2:4]
    conf = match_pack[:, 4]
    pts, valid, ro_np = _surface_anchors(obj_params, obj_cfg, coord_prev, K, prev_pose_w2c,
                                         inverse_y, near, far)
    valid = valid & (conf > 0)
    if valid.sum() < 6:
        return prev_pose_w2c.copy()

    # scene depth at the same pixels of the previous (trained) view
    center, ray, depth = _scene_depth_at(scene_params, scene_cfg, coord_prev, K, prev_pose_w2c,
                                         (near, far), progress, use_fine)
    pts_scene = (center + ray * depth[:, None]).cpu().numpy()

    r_obj = np.linalg.norm(pts - ro_np, axis=1)
    r_scene = np.linalg.norm(pts_scene - ro_np, axis=1)
    ok = valid & (r_obj > 1e-6)
    ratio = float(np.clip(np.median(r_scene[ok] / r_obj[ok]), 0.5, 2.0))
    pts_fixed = ro_np + (pts - ro_np) * ratio

    world_pts = pts_fixed[valid].astype(np.float64)
    img_pts = coord_cur[valid].astype(np.float64)
    return solve_pnp(world_pts, img_pts, K, prev_pose_w2c)


def _holdout_reproj(world_pts: np.ndarray, img_pts: np.ndarray, K: np.ndarray,
                    prev_pose_w2c: np.ndarray) -> float:
    """Cross-validated reprojection error (px): solve PnP on each half of the
    anchors, score the median reprojection on the other half, return the max.

    A geometrically degenerate anchor set (shallow spread, near-planar patch)
    can fit its own points tightly while the pose is far off. Such solves do
    not generalize across a holdout split, so this metric separates them from
    genuinely well-constrained solves (which stay at the sub-pixel level)."""
    n = len(world_pts)
    if n < 12:
        return float("inf")  # too few anchors to cross-validate => distrust
    err = 0.0
    for a, b in ((slice(0, None, 2), slice(1, None, 2)),
                 (slice(1, None, 2), slice(0, None, 2))):
        pose_a, fb = _solve_core(world_pts[a], img_pts[a], K, prev_pose_w2c)
        if fb:
            return float("inf")
        err = max(err, _median_reproj_err(pose_a, world_pts[b], img_pts[b], K))
    return float(err)


def solve_pnp(world_pts: np.ndarray, img_pts: np.ndarray, K: np.ndarray,
              prev_pose_w2c: np.ndarray) -> np.ndarray:
    """PnP-RANSAC + LM refine with a previous-pose sanity fallback.

    Stashes a quality diagnostic in module-level `LAST_QUALITY` (host-only,
    single-threaded): median reprojection error (px) of the returned pose over
    all anchor points, the holdout cross-validation error (`_holdout_reproj`),
    point count, and whether a fallback path fired. The trainer reads it to
    decide whether the pose needs a photometric warmup rescue."""
    global LAST_QUALITY
    pose, fallback = _solve_core(world_pts, img_pts, K, prev_pose_w2c)
    LAST_QUALITY = {
        "med_reproj_px": _median_reproj_err(pose, world_pts, img_pts, K),
        "holdout_reproj_px": (float("inf") if fallback else
                              _holdout_reproj(world_pts, img_pts, K, prev_pose_w2c)),
        "n_pts": len(world_pts), "fallback": fallback,
        # anchors retained so the trainer can score candidate poses (e.g. the
        # activation photometric warmup) on the same geometry -- the one
        # signal the scene render cannot co-adapt to
        "world_pts": np.asarray(world_pts), "img_pts": np.asarray(img_pts),
        "K": np.asarray(K),
    }
    return pose


def reproj_for_pose(quality: dict, pose_w2c: np.ndarray) -> float:
    """Median anchor-reprojection error (px) of a candidate pose on the
    anchors retained in a `solve_pnp` quality dict; inf if unavailable."""
    if not quality or "world_pts" not in quality:
        return float("inf")
    return _median_reproj_err(np.asarray(pose_w2c), quality["world_pts"],
                              quality["img_pts"], quality["K"])


def _solve_core(world_pts: np.ndarray, img_pts: np.ndarray, K: np.ndarray,
                prev_pose_w2c: np.ndarray) -> tuple[np.ndarray, bool]:
    """One PnP solve (no quality bookkeeping). Returns (pose, fallback?)."""
    if _HAS_CV2:
        K64 = K.astype(np.float64)
        dist = np.zeros((4, 1))
        ok, rvec, tvec, inliers = cv2.solvePnPRansac(world_pts, img_pts, K64, dist,
                                                     reprojectionError=4.0,
                                                     iterationsCount=300)
        if not ok:
            return prev_pose_w2c.copy(), True
        # LM refinement on the inliers: surface anchors sit on 1-2 probe faces
        # (near-planar), where raw RANSAC-P3P solutions can be unstable
        if inliers is not None and len(inliers) >= 6:
            sel = inliers[:, 0]
            try:
                rvec, tvec = cv2.solvePnPRefineLM(world_pts[sel], img_pts[sel], K64,
                                                  dist, rvec, tvec)
            except cv2.error:
                pass
        R = lie.so3_to_SO3(torch.as_tensor(np.asarray(rvec, np.float32).reshape(1, 3)))[0].numpy()
        pose = np.concatenate([R, np.asarray(tvec, np.float32).reshape(3, 1)], axis=1)
        # sanity: if the solved pose reprojects worse than simply reusing the
        # previous pose, keep the previous pose (robust chain behavior)
        if _median_reproj_err(pose, world_pts, img_pts, K) > \
                _median_reproj_err(prev_pose_w2c, world_pts, img_pts, K):
            return prev_pose_w2c.copy(), True
        return pose, False
    return _pnp_ransac_numpy(world_pts, img_pts, K, prev_pose_w2c), False


#: quality of the most recent `solve_pnp` call (see its docstring); None when
#: the caller bailed out before reaching RANSAC (too few valid matches)
LAST_QUALITY: dict | None = None


def pnp_from_scene_depth(
    scene_params: dict,
    scene_cfg,
    match_pack: np.ndarray,     # [M, 5]: (x_prev, y_prev, x_cur, y_cur, conf)
    K: np.ndarray,              # [3, 3]
    prev_pose_w2c: np.ndarray,  # [3, 4]
    depth_range,
    progress: float,
    use_fine: bool = False,
) -> np.ndarray:
    """PnP anchored on the scene NeRF's rendered depth.

    Anchoring on depth rendered by the scene branch at the matched pixels of
    the already-calibrated previous view puts the 3D anchors in the same gauge
    as the existing poses, so the new pose lands scale-consistent (the probe
    SDF's deformation field leaves a global scale ambiguity). Only usable once
    the scene NeRF has trained a while.
    """
    match_pack = np.asarray(match_pack)
    coord_prev = match_pack[:, 0:2]
    coord_cur = match_pack[:, 2:4]
    conf = match_pack[:, 4]
    valid = conf > 0
    if valid.sum() < 6:
        return prev_pose_w2c.copy()

    device = _device_of(scene_params)
    _, _, depth = _scene_depth_at(scene_params, scene_cfg, coord_prev, K, prev_pose_w2c,
                                  depth_range, progress, use_fine)
    # backproject through the previous pose -> world anchors in the scene gauge
    c2w_prev = pose_ops.invert_4x4(pose_ops.pad(_t32(prev_pose_w2c, device)))
    pts3d = geometry.batch_backproject_to_3d(_t32(coord_prev, device), depth, _t32(K, device),
                                             c2w_prev).cpu().numpy()
    world_pts = pts3d[valid].astype(np.float64)
    img_pts = coord_cur[valid].astype(np.float64)
    return solve_pnp(world_pts, img_pts, K, prev_pose_w2c)


def _median_reproj_err(pose_w2c, world_pts, img_pts, K) -> float:
    pc = world_pts @ np.asarray(pose_w2c[:, :3], np.float64).T + np.asarray(pose_w2c[:, 3], np.float64)
    z = np.clip(pc[:, 2], 1e-6, None)
    px = (pc[:, :2] / z[:, None]) @ K[:2, :2].T + K[:2, 2]
    return float(np.median(np.linalg.norm(px - img_pts, axis=1)))


def _pnp_dlt(world_pts: np.ndarray, img_pts: np.ndarray, K: np.ndarray) -> np.ndarray | None:
    """Direct linear transform pose (needs >= 6 points)."""
    n = len(world_pts)
    norm = np.linalg.inv(K) @ np.concatenate([img_pts, np.ones((n, 1))], 1).T
    u, v = norm[0], norm[1]
    A = np.zeros((2 * n, 12))
    X = np.concatenate([world_pts, np.ones((n, 1))], 1)
    A[0::2, 0:4] = X
    A[0::2, 8:12] = -u[:, None] * X
    A[1::2, 4:8] = X
    A[1::2, 8:12] = -v[:, None] * X
    _, _, Vt = np.linalg.svd(A)
    P = Vt[-1].reshape(3, 4)
    R_raw = P[:, :3]
    U, S, Vt2 = np.linalg.svd(R_raw)
    scale = S.mean()
    if scale < 1e-12:
        return None
    R = U @ Vt2
    if np.linalg.det(R) < 0:
        R, P = -R, -P
    t = P[:, 3] / scale
    # fix cheirality: points should be in front (positive z)
    z = (world_pts @ R.T + t)[:, 2]
    if np.median(z) < 0:
        return None
    return np.concatenate([R, t[:, None]], 1).astype(np.float32)


def _pnp_ransac_numpy(world_pts, img_pts, K, fallback, iters: int = 200, thresh: float = 4.0):
    """Minimal DLT-based RANSAC PnP (the solver when cv2 is unavailable).
    Its sample draws come from a fixed seed, so a solve is reproducible."""
    rng = np.random.default_rng(0)
    n = len(world_pts)
    best_inliers, best_pose = 0, None
    for _ in range(iters):
        sel = rng.choice(n, size=min(6, n), replace=False)
        pose = _pnp_dlt(world_pts[sel], img_pts[sel], K)
        if pose is None:
            continue
        pc = world_pts @ pose[:, :3].T + pose[:, 3]
        z = np.clip(pc[:, 2], 1e-6, None)
        px = (pc[:, :2] / z[:, None]) @ K[:2, :2].T + K[:2, 2]
        err = np.linalg.norm(px - img_pts, axis=1)
        inliers = (err < thresh) & (pc[:, 2] > 0)
        if inliers.sum() > best_inliers:
            best_inliers = int(inliers.sum())
            refined = _pnp_dlt(world_pts[inliers], img_pts[inliers], K)
            best_pose = refined if refined is not None else pose
    if best_pose is None or best_inliers < 6:
        return fallback.copy()
    return best_pose


def initialize_poses_pnp(
    obj_params: dict,
    obj_cfg: object_sdf.ObjectConfig,
    data,
    use_identical: bool = False,
) -> np.ndarray:
    """Incremental PnP chain: pose[0] = GT anchor, pose[i] from matches vs pose[i-1]."""
    poses = [np.asarray(data.poses_gt_w2c[data.i_train[0]], np.float32)]
    for idx in range(1, data.n_train):
        if use_identical:
            poses.append(poses[idx - 1].copy())
            continue
        i = data.i_train[idx]
        extra = None
        if data.scene_matches is not None:
            extra = [np.asarray(data.scene_matches[idx])]
        poses.append(pnp_from_matches(
            obj_params, obj_cfg, data.obj_matches[idx], data.Ks[i], poses[idx - 1],
            inverse_y=data.inverse_y, near=data.near, far=data.far,
            extra_packs=extra))
    return np.stack(poses)
