"""DTU mesh evaluation protocol: masked, culled chamfer against GT points.

Port of `poseprobe_tpu/eval/dtu_protocol.py`: sample points from the
predicted mesh, cull both sets to the observation bounding box and, where
given, by an observation-mask criterion (the visual hull, the observed space,
visibility in a view), compute clipped d2s (data-to-stl) and s2d
(stl-to-data) distances with the standard `max_dist=20` (mm) truncation and
report their means and the overall average, beside the same after a trimmed
sim3 ICP (shape error apart from gauge-transfer error). The nearest-neighbour
search is the native grid hash of `eval/mesh.py`.
"""
from __future__ import annotations

import numpy as np

from . import mesh as mesh_mod

MAX_DIST = 20.0       # mm truncation (dtu_eval.py)
DOWNSAMPLE = 0.2      # point spacing for mesh surface sampling (mm)


def load_stl_points(path: str, max_points: int = 2_000_000) -> np.ndarray:
    """Load GT points from the DTU `stl_total.ply` (ascii or binary-le floats)."""
    verts = []
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            line = f.readline()
            header += line
        text = header.decode("ascii", "ignore")
        n_verts = int([l for l in text.splitlines() if l.startswith("element vertex")][0].split()[-1])
        binary = "binary" in text
        n_props = len([l for l in text.splitlines() if l.startswith("property") and "list" not in l])
        if binary:
            data = np.fromfile(f, dtype="<f4", count=n_verts * n_props).reshape(n_verts, n_props)
            verts = data[:, :3]
        else:
            rows = [f.readline().split()[:3] for _ in range(n_verts)]
            verts = np.asarray(rows, np.float32)
    verts = np.asarray(verts, np.float32)
    if len(verts) > max_points:
        sel = np.random.default_rng(0).choice(len(verts), max_points, replace=False)
        verts = verts[sel]
    return verts


def project_to_views(points: np.ndarray, poses_w2c: np.ndarray, Ks: np.ndarray):
    """Project [N,3] world points into V views: (uv [V,N,2], z [V,N])."""
    R, t = poses_w2c[:, :3, :3], poses_w2c[:, :3, 3]
    cam = np.einsum("vij,nj->vni", R, points) + t[:, None, :]
    z = cam[..., 2]
    px = np.einsum("vij,vnj->vni", Ks, cam)
    uv = px[..., :2] / np.clip(px[..., 2:3], 1e-9, None)
    return uv, z


def _dilate_mask(mask: np.ndarray, r: int) -> np.ndarray:
    """Binary max-filter dilation with a (2r+1) square kernel (numpy rolls)."""
    out = mask.astype(bool)
    for axis in (0, 1):
        acc = out.copy()
        for s in range(1, r + 1):
            acc |= np.roll(out, s, axis) | np.roll(out, -s, axis)
        out = acc
    return out


def visual_hull_cull(points: np.ndarray, masks: np.ndarray,
                     poses_w2c: np.ndarray, Ks: np.ndarray,
                     dilate_px: int = 2) -> np.ndarray:
    """Keep points inside every view's (dilated) object silhouette.

    The analog of `lib/dtu_eval.py`'s ObsMask culling of the PREDICTED set:
    points on the real object project inside the silhouette in all views (the
    object is fully visible), so anything escaping a mask is unobserved-region
    garbage the reconstruction was never supervised on. Views where the point
    falls outside the image don't vote.
    Returns a boolean keep-mask [N].
    """
    V, H, W = masks.shape[0], masks.shape[1], masks.shape[2]
    uv, z = project_to_views(points, poses_w2c, Ks)
    keep = np.ones(len(points), bool)
    for v in range(V):
        m = _dilate_mask(masks[v, ..., 0] > 0.5, dilate_px)
        u_i = np.round(uv[v, :, 0] - 0.5).astype(int)
        v_i = np.round(uv[v, :, 1] - 0.5).astype(int)
        in_img = (z[v] > 0) & (u_i >= 0) & (u_i < W) & (v_i >= 0) & (v_i < H)
        inside = np.zeros(len(points), bool)
        inside[in_img] = m[v_i[in_img], u_i[in_img]]
        keep &= np.where(in_img, inside, True)
    return keep


def visible_in_any_view(points: np.ndarray, depth_maps: np.ndarray,
                        poses_w2c: np.ndarray, Ks: np.ndarray,
                        tol: float = 0.05) -> np.ndarray:
    """Keep GT points observed (depth-tested) in at least one view.

    The analog of culling the GT scan to the observation mask: a surface
    point the training views never saw (self-occluded back side) cannot be
    reconstructed and is not scored — `lib/dtu_eval.py` applies the dataset's
    ObsMask for exactly this. Returns a boolean keep-mask [N].
    """
    V, H, W = depth_maps.shape[0], depth_maps.shape[1], depth_maps.shape[2]
    uv, z = project_to_views(points, poses_w2c, Ks)
    seen = np.zeros(len(points), bool)
    for v in range(V):
        u_i = np.round(uv[v, :, 0] - 0.5).astype(int)
        v_i = np.round(uv[v, :, 1] - 0.5).astype(int)
        in_img = (z[v] > 0) & (u_i >= 0) & (u_i < W) & (v_i >= 0) & (v_i < H)
        idx = np.where(in_img)[0]
        zmap = depth_maps[v][v_i[idx], u_i[idx]]
        seen[idx] |= np.abs(z[v][idx] - zmap) < tol * np.maximum(zmap, 1.0)
    return seen


def observed_space_cull(points: np.ndarray, depth_maps: np.ndarray,
                        poses_w2c: np.ndarray, Ks: np.ndarray,
                        tol: float = 0.05) -> np.ndarray:
    """Keep points in OBSERVED space: unoccluded (z <= GT depth + tol) in at
    least one view. Space behind the GT surface in every view was never
    supervised by any ray; surfaces the SDF hallucinates there are not
    scored, while floaters in observed free space are real errors and stay.
    This is the ObsMask semantics of `lib/dtu_eval.py` (observed-volume mask
    shipped with the DTU benchmark). Returns a boolean keep-mask [N].
    """
    V, H, W = depth_maps.shape[0], depth_maps.shape[1], depth_maps.shape[2]
    uv, z = project_to_views(points, poses_w2c, Ks)
    observed = np.zeros(len(points), bool)
    for v in range(V):
        u_i = np.round(uv[v, :, 0] - 0.5).astype(int)
        v_i = np.round(uv[v, :, 1] - 0.5).astype(int)
        in_img = (z[v] > 0) & (u_i >= 0) & (u_i < W) & (v_i >= 0) & (v_i < H)
        idx = np.where(in_img)[0]
        zmap = depth_maps[v][v_i[idx], u_i[idx]]
        observed[idx] |= z[v][idx] <= zmap + tol * np.maximum(zmap, 1.0)
    return observed


def icp_refine_sim3(pred_pts: np.ndarray, gt_points: np.ndarray,
                    iters: int = 5, trim_pct: float = 80.0) -> np.ndarray:
    """Trimmed sim3 ICP of pred points onto the GT cloud (diagnostic only).

    The hermetic protocol maps meshes into GT units with the sim3 that aligns
    the TRAIN POSES (camera-center gauge). The probe-scale ambiguity can leave
    the probe's own gauge off the camera gauge, so the ICP-refined chamfer
    separates SHAPE error from GAUGE-TRANSFER error. Reported as `*_icp` fields next
    to the headline camera-gauge numbers, never instead of them.
    """
    from scipy.spatial import cKDTree

    tree = cKDTree(gt_points)
    P = np.asarray(pred_pts, np.float64).copy()
    for _ in range(iters):
        d, idx = tree.query(P, workers=-1)
        keep = d < np.percentile(d, trim_pct)
        if keep.sum() < 16:
            break
        A, B = P[keep], gt_points[idx[keep]]
        muA, muB = A.mean(0), B.mean(0)
        Ac, Bc = A - muA, B - muB
        U, S, Vt = np.linalg.svd(Ac.T @ Bc / len(A))
        D = np.eye(3)
        if np.linalg.det(U @ Vt) < 0:
            D[2, 2] = -1
        R = U @ D @ Vt
        s = np.trace(np.diag(S) @ D) / (Ac ** 2).mean(0).sum()
        t = muB - s * (muA @ R)
        P = s * (P @ R) + t
    return P.astype(np.float32)


def evaluate_mesh_dtu(pred_verts: np.ndarray, pred_tris: np.ndarray,
                      gt_points: np.ndarray, bbox: np.ndarray | None = None,
                      n_samples: int = 500_000, max_dist: float = MAX_DIST,
                      pred_cull=None, gt_cull=None):
    """Returns dict(d2s, s2d, overall) in GT units (mm for DTU).

    `pred_cull` / `gt_cull`: optional callables points[N,3] -> bool keep-mask
    (observation-mask culling, `visual_hull_cull` / `visible_in_any_view`).
    """
    pred_pts = mesh_mod.sample_mesh_surface(pred_verts, pred_tris, n_samples)
    if len(pred_pts) == 0:
        # degenerate prediction: every GT point scores the max distance,
        # matching the DTU convention of clamping unmatched distances
        return {"d2s": float(max_dist), "s2d": float(max_dist),
                "overall": float(max_dist), "empty_mesh": True}
    if bbox is not None:
        lo, hi = bbox[0], bbox[1]
        keep_p = np.all((pred_pts >= lo) & (pred_pts <= hi), axis=1)
        keep_g = np.all((gt_points >= lo) & (gt_points <= hi), axis=1)
        pred_pts = pred_pts[keep_p] if keep_p.any() else pred_pts
        gt_points = gt_points[keep_g] if keep_g.any() else gt_points
    stats = {}
    if pred_cull is not None:
        keep = pred_cull(pred_pts)
        stats["pred_culled_frac"] = float(1.0 - keep.mean())
        if keep.any():
            pred_pts = pred_pts[keep]
    if gt_cull is not None:
        keep = gt_cull(gt_points)
        stats["gt_culled_frac"] = float(1.0 - keep.mean())
        if keep.any():
            gt_points = gt_points[keep]
    d2s = np.sqrt(mesh_mod.nearest_sqdist(pred_pts, gt_points))
    s2d = np.sqrt(mesh_mod.nearest_sqdist(gt_points, pred_pts))
    d2s = np.minimum(d2s, max_dist)
    s2d = np.minimum(s2d, max_dist)
    out = {
        "d2s": float(d2s.mean()),
        "s2d": float(s2d.mean()),
        "overall": float((d2s.mean() + s2d.mean()) / 2),
        **stats,
    }
    # gauge-vs-shape decomposition (see icp_refine_sim3)
    pred_icp = icp_refine_sim3(pred_pts[:: max(len(pred_pts) // 200_000, 1)], gt_points)
    d2s_i = np.minimum(np.sqrt(mesh_mod.nearest_sqdist(pred_icp, gt_points)), max_dist)
    s2d_i = np.minimum(np.sqrt(mesh_mod.nearest_sqdist(gt_points, pred_icp)), max_dist)
    out["d2s_icp"] = float(d2s_i.mean())
    out["s2d_icp"] = float(s2d_i.mean())
    out["overall_icp"] = float((d2s_i.mean() + s2d_i.mean()) / 2)
    return out
