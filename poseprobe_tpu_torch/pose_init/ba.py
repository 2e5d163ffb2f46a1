"""Host-side match-based bundle-adjustment pose polish.

The port's own copy of `poseprobe_tpu/pose_init/ba.py` (numpy, optional
OpenCV; no device code): `observations_from_packs`, `view_match_med_px`,
`refine_view_matches` and `polish_poses_matches`.

Why it exists: translation error is injected at view activations (PnP in the
probe's drifting scale gauge) and then plateaus -- the scene NeRF co-adapts to
the wrong translations, so every render-based correction converges to the
same self-consistent distortion. The one pose-information source the scene
cannot co-adapt to is the match set itself: pairwise correspondences pin the
multi-view geometry independently of any rendered quantity.

A joint Levenberg-Marquardt bundle adjustment runs on the host over the
load-time match packs. Structure is handled by variable projection: every
residual evaluation re-triangulates all pair points (DLT) from the current
poses, so the optimization runs over pose parameters only (6 per non-anchor
view) with a numeric Jacobian. Robustness: a pre-trim pass drops gross
outliers, and Huber IRLS weights absorb the rest. Chain pairs (i-1, i) alone
leave each pair's translation scale free, so callers include skip pairs
(i-2, i): the view triangles then propagate relative scale down the chain;
only the global gauge stays free, anchored by fixing view 0.

Triangulation is OpenCV's (`cv2.triangulatePoints`). Without `cv2` every
entry point declines (`info["applied"] = False`; `view_match_med_px` gives
inf), as the reference's do: the trainer then keeps its poses. Host-side, event-time only -- never on the hot path.
"""
from __future__ import annotations

import numpy as np

try:
    import cv2
    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False


def observations_from_packs(packs, pair_ab, n_active: int):
    """Normalize match packs to BA observations.

    packs: [n_packs, M, 5] arrays (x_a, y_a, x_b, y_b, conf), zero-padded.
    pair_ab: [n_packs, 2] train-local (a, b) view indices per pack.
    Packs touching views >= n_active are dropped (inactive views have no
    trained pose yet). Returns list of (a, b, px_a [m,2], px_b [m,2]).
    """
    obs = []
    for pack, (a, b) in zip(packs, pair_ab):
        a, b = int(a), int(b)
        if a >= n_active or b >= n_active or a == b:
            continue
        pk = np.asarray(pack)
        valid = pk[:, 4] > 0
        if valid.sum() < 8:
            continue
        obs.append((a, b, pk[valid, 0:2].astype(np.float64),
                    pk[valid, 2:4].astype(np.float64)))
    return obs


def _triangulate(K_a, K_b, pose_a, pose_b, px_a, px_b):
    """DLT triangulation -> world points [m, 3] + cheirality mask.

    Takes per-view intrinsics: the DTU loader decomposes genuinely per-view
    K matrices, so projecting view b through K_a biases residuals against
    the 0.15 px accept gate (an earlier finding of the project).
    """
    P_a = K_a @ pose_a
    P_b = K_b @ pose_b
    X = cv2.triangulatePoints(P_a, P_b, px_a.T.astype(np.float64),
                              px_b.T.astype(np.float64))
    w = X[3]
    w = np.where(np.abs(w) < 1e-12, 1e-12, w)
    pts = (X[:3] / w).T
    z_a = pts @ pose_a[2, :3] + pose_a[2, 3]
    z_b = pts @ pose_b[2, :3] + pose_b[2, 3]
    return pts, (z_a > 1e-3) & (z_b > 1e-3)


def _reproj_err(K, pose, pts, px):
    pc = pts @ pose[:, :3].T + pose[:, 3]
    z = np.clip(pc[:, 2], 1e-9, None)
    proj = (pc[:, :2] / z[:, None]) @ K[:2, :2].T + K[:2, 2]
    return np.linalg.norm(proj - px, axis=1)


def _so3_exp(w):
    th = np.linalg.norm(w)
    Wx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-12:
        return np.eye(3) + Wx
    return (np.eye(3) + np.sin(th) / th * Wx
            + (1 - np.cos(th)) / th ** 2 * (Wx @ Wx))


def _poses_from(theta, base, free):
    """Left-multiplicative se3 deltas on the free views of `base`."""
    out = base.copy()
    th = theta.reshape(len(free), 6)
    for k, v in enumerate(free):
        w, u = th[k, :3], th[k, 3:]
        R = _so3_exp(w)
        out[v, :, :3] = R @ base[v, :, :3]
        out[v, :, 3] = R @ base[v, :, 3] + u
    return out


def _huber_sqrt_w(r, delta):
    e = np.abs(r)
    return np.sqrt(np.where(e <= delta, 1.0, delta / np.maximum(e, 1e-12)))


def view_match_med_px(poses_w2c, Ks, obs, view: int) -> float:
    """Median reprojection residual (px) of `view`'s CURRENT pose over the
    match packs touching it (triangulating against the other poses). The
    trainer uses this as the refine trigger: a pose already consistent
    with the packs is left alone — at weak conditioning (64 px, 2
    partners, near-planar matches) several poses fit the packs equally
    well, so "refining" a consistent pose can hop basins (observed:
    R 1.66 / t x100 5.3 -> R 2.5 / t 48 at med 0.02 px). Without cv2 there
    is no triangulation: inf, so the caller goes on to `refine_view_matches`,
    which declines (the reference raises a NameError here instead)."""
    if not _HAS_CV2:
        return float("inf")
    poses = np.asarray(poses_w2c, np.float64)
    K_all = np.asarray(Ks, np.float64)
    es = []
    for a, b, pa, pb in obs:
        if view not in (a, b):
            continue
        pts, ok = _triangulate(K_all[a], K_all[b], poses[a], poses[b], pa, pb)
        e = np.maximum(_reproj_err(K_all[a], poses[a], pts, pa),
                       _reproj_err(K_all[b], poses[b], pts, pb))
        es.append(np.where(ok, np.minimum(e, 1e3), 1e3))
    if not es:
        return float("inf")
    return float(np.median(np.concatenate(es)))


def refine_view_matches(poses_w2c, Ks, obs, view: int, starts=None,
                        iters: int = 30, huber_px: float = 2.0,
                        trim_px: float = 6.0):
    """Single-view match refinement: LM over ONE view's 6-dof pose on the
    match packs touching it, all other poses fixed (the activation
    rescue).

    Why: activation-time PnP can return solves that fit their own anchors
    to 0.3 px yet sit 6-12 deg off (self-consistent-but-wrong), and the photometric referee can prefer corrupted poses (the
    scene generalizes poorly at a new view). The view's pairwise matches
    against ALREADY-TRUSTED views are the remaining referee: a wrong pose
    cannot reproject the pair geometry consistently. One view against
    fixed partners is a benign 6-dof problem — multi-start LM (PnP pose +
    the previous view's pose by default) converges from far-off inits.

    Returns (pose [3,4], info): the best candidate by robust cost, with
    info["med_px"] the converged median residual (callers gate acceptance
    on it) and info["start"] which start won. Falls back to poses_w2c[view]
    when cv2 or observations are missing.
    """
    poses = np.asarray(poses_w2c, np.float64).copy()
    K_all = np.asarray(Ks, np.float64)
    vobs = [(a, b, pa, pb) for (a, b, pa, pb) in obs if view in (a, b)]
    info = {"applied": False, "n_packs": len(vobs), "med_px": float("inf")}
    if not _HAS_CV2 or not vobs:
        return poses[view].astype(np.float32), info
    if starts is None:
        starts = [("pnp", poses[view])]

    def residuals_for(pose_v):
        """Robust per-point residual magnitudes across the view's packs."""
        p = poses.copy()
        p[view] = pose_v
        rs = []
        for a, b, pa, pb in vobs:
            pts, ok = _triangulate(K_all[a], K_all[b], p[a], p[b], pa, pb)
            e = np.maximum(_reproj_err(K_all[a], p[a], pts, pa),
                           _reproj_err(K_all[b], p[b], pts, pb))
            rs.append(np.where(ok, np.minimum(e, 1e3), 1e3))
        return np.concatenate(rs)

    def robust_cost(pose_v):
        e = residuals_for(pose_v)
        w = np.where(e <= huber_px, 1.0, huber_px / np.maximum(e, 1e-12))
        return float(np.sum(w * e ** 2)), float(np.median(e))

    def lm_one(pose0):
        """Graduated robust LM: a large Huber scale first smooths the
        landscape (the 12-deg-off basin has local minima at 64-px
        conditioning — measured med 1.04 px stalls with a fixed 2-px
        delta), then anneal toward the working scale."""
        pose = pose0.copy()
        for delta in (4 * huber_px, 2 * huber_px, huber_px):
            lam = 1e-3
            for _ in range(max(iters // 3, 8)):
                e = residuals_for(pose)
                keep = e < max(trim_px, 3.0 * np.median(e))
                if keep.sum() < 8:
                    return pose

                def res_vec(th):
                    R = _so3_exp(th[:3])
                    pv = pose.copy()
                    pv[:, :3] = R @ pose[:, :3]
                    pv[:, 3] = R @ pose[:, 3] + th[3:]
                    return residuals_for(pv)[keep]

                r = res_vec(np.zeros(6))
                w = _huber_sqrt_w(r, delta)
                J = np.zeros((len(r), 6))
                eps = 1e-6
                for k in range(6):
                    th = np.zeros(6)
                    th[k] = eps
                    J[:, k] = (res_vec(th) - r) / eps
                Jw = J * w[:, None]
                A = Jw.T @ Jw
                g = Jw.T @ (r * w)
                stepped = False
                for _ in range(8):
                    try:
                        dth = np.linalg.solve(
                            A + lam * np.diag(np.diag(A) + 1e-12), -g)
                    except np.linalg.LinAlgError:
                        lam *= 10
                        continue
                    R = _so3_exp(dth[:3])
                    cand = pose.copy()
                    cand[:, :3] = R @ pose[:, :3]
                    cand[:, 3] = R @ pose[:, 3] + dth[3:]
                    c_old = float(np.sum((r * w) ** 2))
                    e_new = residuals_for(cand)[keep]
                    w_new = _huber_sqrt_w(e_new, delta)
                    if float(np.sum((e_new * w_new) ** 2)) < c_old:
                        pose = cand
                        lam = max(lam * 0.3, 1e-9)
                        stepped = True
                        break
                    lam *= 10
                if not stepped:
                    break
        return pose

    # plausibility bound: under noisy near-planar packs the variable-
    # projection cost has an UNBOUNDED degenerate direction — the view can
    # recede arbitrarily while its own triangulations chase it (observed: a
    # "solution" at 16k world units with med 0.21 px). A genuine activation
    # correction stays within a few camera baselines of the trusted set.
    def center(p):
        return -p[:, :3].T @ p[:, 3]

    partners = sorted({v for (a, b, _, _) in obs for v in (a, b)} - {view})
    p_centers = np.stack([center(poses[v]) for v in partners]) \
        if partners else center(poses[view])[None]
    base = max(float(np.linalg.norm(
        p_centers[:, None] - p_centers[None], axis=-1).max()), 1e-3)
    centroid = p_centers.mean(0)

    best = None
    for tag, p0 in starts:
        refined = lm_one(np.asarray(p0, np.float64))
        cost, med = robust_cost(refined)
        dist = float(np.linalg.norm(center(refined) - centroid))
        if dist > 10.0 * base:
            continue  # degenerate far-field basin
        # strict-improvement tie-break: with a near-degenerate direction
        # (narrow-baseline + planar matches), several basins can converge to
        # ~equal robust cost but very different translations — earlier
        # starts carry more prior information (callers order them PnP
        # first: its anchors pin the translation scale), so a later start
        # must beat the incumbent by >0.1% to win.
        if best is None or cost < 0.999 * best[0]:
            best = (cost, med, refined, tag)
    if best is None:
        info["rejected_far_field"] = True
        return poses[view].astype(np.float32), info
    _, med, pose, tag = best
    info.update(applied=True, med_px=float(med), start=tag)
    return pose.astype(np.float32), info


def polish_poses_matches(poses_w2c, Ks, obs, fix_first: bool = True,
                         rounds: int = 25, trim_px: float = 4.0,
                         huber_px: float = 2.0,
                         prior_sigma_rot: float = 0.05,
                         prior_sigma_trans: float = 0.10,
                         max_noise_px: float = 0.15):
    """Joint LM bundle adjustment over match observations (module docstring).

    poses_w2c: [n, 3, 4]; Ks: [n, 3, 3]; obs from `observations_from_packs`.
    Returns (polished_poses [n, 3, 4], info dict). Falls back to the input
    poses (info["applied"]=False) without cv2, with too few observations, or
    if the optimization failed to reduce the robust cost.

    Collapse guard: with pairwise-only structure, reprojection cost has a
    DEGENERATE descent direction — shrinking baselines lets triangulated
    depth absorb localisation noise (as baselines -> 0 only the epipolar
    component of the noise remains visible), so under heavy noise the global
    minimum drifts the cameras together. Two defenses: a soft trust-region
    prior on the se3 corrections (`prior_sigma_*`, calibrated to the
    activation-injection error scale this polish exists to fix), and a hard
    reject when the median pairwise baseline shrinks or grows >20% (the
    collapse signature; a genuine polish preserves baselines to a few %).
    """
    start = np.asarray(poses_w2c, np.float64).copy()
    n = len(start)
    info = {"applied": False, "rounds": 0, "med_reproj_px": float("nan"),
            "n_points": 0, "n_trimmed": 0}
    if not _HAS_CV2 or not obs or n < 2:
        return start.astype(np.float32), info
    free = list(range(1 if fix_first else 0, n))
    if not free:
        return start.astype(np.float32), info

    def select_inliers(poses):
        """Trim with the CURRENT poses: cheirality failures and gross
        mismatches (which triangulate inconsistently under any nearby poses)
        are excluded entirely — a near-degenerate triangulation otherwise
        produces ~1e9-px residuals that dominate even a Huber cost."""
        kept, dropped = [], 0
        for a, b, px_a, px_b in obs:
            K_a = np.asarray(Ks[a], np.float64)
            K_b = np.asarray(Ks[b], np.float64)
            pts, ok = _triangulate(K_a, K_b, poses[a], poses[b], px_a, px_b)
            e = np.maximum(_reproj_err(K_a, poses[a], pts, px_a),
                           _reproj_err(K_b, poses[b], pts, px_b))
            e = np.where(ok, e, np.inf)
            if ok.sum() < 8:
                dropped += len(px_a)
                continue
            keep = e < max(trim_px, 3.0 * np.median(e[ok]))
            dropped += int((~keep).sum())
            if keep.sum() >= 8:
                kept.append((a, b, px_a[keep], px_b[keep]))
        return kept, dropped

    def _center(pose):
        return -pose[:, :3].T @ pose[:, 3]

    # scale-gauge anchor: pairwise reprojection leaves the GLOBAL scale about
    # camera 0 as a null direction, and under match noise the minimum drifts
    # far along it (observed baseline ratios 2-8x on noisy packs). Global
    # scale is pure gauge for this pipeline (pose metrics align sim3; the
    # scene NeRF trains in whatever gauge the poses define), so pin the
    # first baseline's log-length to its input value with a stiff penalty —
    # shape corrections stay free, the null direction dies.
    _all = np.asarray(poses_w2c, np.float64)
    d01_ref = max(np.linalg.norm(_center(_all[1]) - _center(_all[0])), 1e-9) \
        if n >= 2 else 1.0
    GAUGE_W = 100.0

    def lm(theta, base, theta_total, cur_obs, delta, iters, prior_scale):
        def residuals(th):
            poses = _poses_from(th, base, free)
            rs = []
            for a, b, px_a, px_b in cur_obs:
                K_a = np.asarray(Ks[a], np.float64)
                K_b = np.asarray(Ks[b], np.float64)
                pts, _ = _triangulate(K_a, K_b, poses[a], poses[b],
                                      px_a, px_b)
                for v, K, px in ((a, K_a, px_a), (b, K_b, px_b)):
                    pc = pts @ poses[v][:, :3].T + poses[v][:, 3]
                    z = np.clip(pc[:, 2], 1e-9, None)
                    proj = (pc[:, :2] / z[:, None]) @ K[:2, :2].T + K[:2, 2]
                    rs.append((proj - px).ravel())
            # prior measured against the TOTAL correction across outer rounds
            rs.append((th + theta_total) * prior_scale)
            d01 = max(np.linalg.norm(_center(poses[1]) - _center(poses[0])),
                      1e-9)
            rs.append(np.array([GAUGE_W * np.log(d01 / d01_ref)]))
            return np.concatenate(rs)

        lam = 1e-4
        r = residuals(theta)
        done = 0
        for it in range(iters):
            done = it + 1
            w = _huber_sqrt_w(r, delta)
            rw = r * w
            J = np.zeros((len(r), len(theta)))
            eps = 1e-6
            for k in range(len(theta)):
                tp = theta.copy()
                tp[k] += eps
                J[:, k] = (residuals(tp) - r) / eps
            Jw = J * w[:, None]
            A = Jw.T @ Jw
            g = Jw.T @ rw
            stepped = False
            for _ in range(8):  # LM damping search
                try:
                    dth = np.linalg.solve(
                        A + lam * np.diag(np.diag(A) + 1e-12), -g)
                except np.linalg.LinAlgError:
                    lam *= 10
                    continue
                r_new = residuals(theta + dth)
                c_new = float(np.sum((r_new * _huber_sqrt_w(r_new, delta)) ** 2))
                if c_new < float(np.sum(rw ** 2)):
                    theta, r = theta + dth, r_new
                    lam = max(lam * 0.3, 1e-9)
                    stepped = True
                    break
                lam *= 10
            if not stepped or float(np.sqrt(np.mean(r ** 2))) < 1e-6:
                break
        return theta, r, done

    def solve(prior_scale):
        """Outer trim/solve rounds: masks frozen during each LM so the
        residual vector is consistent for the numeric Jacobian; re-trimmed
        with the improved poses, with the Huber scale annealed toward the
        inlier noise. Returns (poses, baseline_ratio, stats)."""
        base = start
        total_rounds = 0
        r_px = np.array([np.inf])
        theta_total = np.zeros(6 * len(free))
        n_pts = n_dropped = 0
        for outer in range(3):
            cur_obs, n_dropped = select_inliers(base)
            if not cur_obs:
                return None, 0.0, {}
            n_pts = sum(len(o[2]) for o in cur_obs)
            # anneal the Huber scale toward the measured inlier residual, but
            # NEVER below ~the noise floor: a delta under the localisation
            # noise makes IRLS lock onto an overfit subset of the matches
            # (observed: GT-start diverging to t x100 ~40 with delta 0.3)
            delta = huber_px if outer == 0 else float(
                np.clip(3.0 * np.median(np.abs(r_px)) * np.sqrt(2),
                        1.0, huber_px))
            theta, r, done = lm(np.zeros(6 * len(free)), base, theta_total,
                                cur_obs, delta, iters=max(rounds // 3, 6),
                                prior_scale=prior_scale)
            r_px = r[:-(6 * len(free) + 1)]  # strip prior + gauge rows
            base = _poses_from(theta, base, free)
            theta_total = theta_total + theta  # approx: deltas are small
            total_rounds += done
            if float(np.sqrt(np.mean(r_px ** 2))) < 1e-6:
                break

        def centers(poses):
            return np.stack([-p[:, :3].T @ p[:, 3] for p in poses])
        c0, c1 = centers(start), centers(base)
        pairs_ab = {(a, b) for a, b, _, _ in obs}
        ratios = [np.linalg.norm(c1[a] - c1[b]) /
                  max(np.linalg.norm(c0[a] - c0[b]), 1e-9)
                  for a, b in pairs_ab]
        stats = {"rounds": total_rounds, "n_points": n_pts,
                 "n_trimmed": n_dropped,
                 "med_px": float(np.median(np.abs(r_px))) * np.sqrt(2)}
        return base, float(np.median(ratios)), stats

    # Stage 1: prior-free — exact on accurate matches (clean analytic /
    # classical SIFT), but free to collapse under heavy noise. Accept only
    # with baselines preserved to ~10% (a genuine polish moves them by a
    # few %; collapse shrinks them). Stage 2 on rejection: trust-region
    # prior bounds the collapse direction at the cost of capping large
    # corrections — a bounded improvement instead of a confident one.
    prior_rows = np.tile(np.concatenate([
        np.full(3, 1.0 / max(prior_sigma_rot, 1e-6)),
        np.full(3, 1.0 / max(prior_sigma_trans, 1e-6))]), len(free))
    base, shrink, stats = solve(np.zeros_like(prior_rows))
    stage = "free"
    # precision override of the baseline-ratio guard: when the free solve
    # explains the matches to sub-noise precision (med residual ~0 px), the
    # solution is the exact multi-view geometry up to the pinned gauge —
    # baseline changes are then a CORRECTION of a badly wrong start, not the
    # noise-collapse the ratio guard exists for (a noise study of the BA: a
    # t x100 ~8 injected start needs >10% baseline moves to heal; the guard
    # misread that as collapse and the prior stage capped the fix at ~half).
    free_exact = (base is not None and stats
                  and stats.get("med_px", np.inf) < 0.05)
    if base is not None:
        info["free_baseline_ratio"] = shrink
        info["free_med_px"] = stats.get("med_px") if stats else None
    if base is None or (not free_exact and not (0.90 < shrink < 1.11)):
        base, shrink, stats = solve(prior_rows)
        stage = "prior"
        if base is None or not (0.8 < shrink < 1.25):
            info["rejected_baseline_ratio"] = shrink
            return start.astype(np.float32), info

    # accept only if the polish reduced the robust cost ON THE FINAL inlier
    # set relative to the start poses (guards against divergence)
    final_obs, _ = select_inliers(base)
    if not final_obs:
        return start.astype(np.float32), info

    def cost_at(poses, cur_obs, delta=1.0):
        tot = 0.0
        for a, b, px_a, px_b in cur_obs:
            K_a = np.asarray(Ks[a], np.float64)
            K_b = np.asarray(Ks[b], np.float64)
            pts, ok = _triangulate(K_a, K_b, poses[a], poses[b], px_a, px_b)
            e = np.maximum(_reproj_err(K_a, poses[a], pts, px_a),
                           _reproj_err(K_b, poses[b], pts, px_b))
            e = np.where(ok, np.minimum(e, 1e3), 1e3)
            w = np.where(e <= delta, 1.0, delta / np.maximum(e, 1e-12))
            tot += float(np.sum(w * e ** 2))
        return tot
    if cost_at(base, final_obs) > cost_at(start, final_obs):
        return start.astype(np.float32), info
    # match-quality gate: the polish only beats the trainer's existing
    # photometric machinery when the matches are PRECISE — the converged
    # inlier residual is the noise proxy. Measured on the 6-view injection
    # benchmark: med 0.02 px (SIFT@128) polishes t x100 8.9 -> <1.0, while
    # med ~0.3 px (1 px synthetic noise at 64 px) lands WORSE than the
    # input. Above the gate, decline and keep the input poses.
    if stats["med_px"] > max_noise_px:
        info["rejected_noise_px"] = stats["med_px"]
        return start.astype(np.float32), info
    info.update(applied=True, rounds=stats["rounds"],
                med_reproj_px=stats["med_px"],
                n_points=int(stats["n_points"]),
                n_trimmed=int(stats["n_trimmed"]),
                baseline_ratio=shrink, stage=stage)
    return base.astype(np.float32), info
