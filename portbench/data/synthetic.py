"""Procedural synthetic scenes (numpy): the benchmark's inputs.

A frozen copy of the port's `data/synthetic.py` (analytic matches only): a
coloured cube "pose probe" on a shaded background wall, ray-cast
analytically, with known GT poses and analytic matches. The benchmark makes
its scenes here, so that a change to the program cannot move them.
`camera_rig` gives the cameras alone, without ray-casting the views.
"""
from __future__ import annotations

import numpy as np

from . import base


def _look_at(cam_pos: np.ndarray, target: np.ndarray, up=np.array([0.0, 1.0, 0.0])):
    """c2w rotation for an inverse_y (+z forward) camera looking at target."""
    fwd = target - cam_pos
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    true_up = np.cross(fwd, right)
    R = np.stack([right, true_up, fwd], axis=1)  # columns = camera axes in world
    return R


def _cube_sdf(p: np.ndarray, half: float) -> np.ndarray:
    d = np.abs(p) - half
    return (np.linalg.norm(np.maximum(d, 0), axis=-1)
            + np.minimum(np.max(d, axis=-1), 0))


def _probe_sdf(p: np.ndarray, half: float, probe: str) -> np.ndarray:
    """SDF of the pose-probe object. "cube" is the shape the object branch is
    initialized as; "sphere" is deliberately NOT cube-shaped so the SIREN
    deformation field (reference `lib/deformation/deform_net.py`) has real
    work to do adapting the cube-SDF init — the paper's "generic objects as
    pose probes" claim exercised on a non-cube probe."""
    if probe == "cube":
        return _cube_sdf(p, half)
    if probe == "sphere":
        return np.linalg.norm(p, axis=-1) - half
    raise ValueError(f"unknown probe shape: {probe!r}")


def probe_surface_points(n: int = 200_000, half: float = 0.35, probe: str = "cube",
                         seed: int = 0) -> np.ndarray:
    """Uniform-area samples [n, 3] of the GT probe surface in world
    coordinates: the synthetic scene's analytic "scan", against which
    `evaluate.py --eval_mesh` scores the extracted object mesh."""
    rng = np.random.default_rng(seed)
    if probe == "sphere":
        v = rng.normal(size=(n, 3))
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
        return (v * half).astype(np.float64)
    if probe == "cube":
        face = rng.integers(0, 6, n)
        uv = rng.uniform(-half, half, (n, 2))
        ax, sg = face // 2, (face % 2) * 2.0 - 1.0
        pts = np.zeros((n, 3))
        rows = np.arange(n)
        pts[rows, ax] = sg * half
        other = np.array([[a for a in range(3) if a != x] for x in range(3)])
        pts[rows, other[ax, 0]] = uv[:, 0]
        pts[rows, other[ax, 1]] = uv[:, 1]
        return pts
    raise ValueError(f"unknown probe shape: {probe!r}")

def _value_noise(u: np.ndarray, v: np.ndarray, seed: float = 0.0,
                 octaves: int = 3, base_freq: float = 6.0) -> np.ndarray:
    """Deterministic smooth value noise in [0, 1], a pure function of (u, v).

    World-anchored texture for the real-matcher protocol: every view sees the
    same pattern at the same surface point (view-consistent), each lattice
    cell is unique (no checker-lattice aliasing — SIFT's ratio test rejects
    repetitive texture, observed: 6-17 matches/pair on the checker probe),
    and the bilinear lattice interpolation keeps it band-limited enough to
    sample stably at 64-128 px. Hash = frac(sin(dot)) lattice, the classic
    shader one-liner — no RNG state, hermetic across processes.
    """
    out = np.zeros_like(u, dtype=np.float64)
    amp_sum = 0.0
    for o in range(octaves):
        f = base_freq * (2.0 ** o)
        amp = 0.5 ** o
        x, y = u * f, v * f
        xi, yi = np.floor(x), np.floor(y)
        xf, yf = x - xi, y - yi
        # smoothstep fade
        sx = xf * xf * (3 - 2 * xf)
        sy = yf * yf * (3 - 2 * yf)

        def h(i, j):
            return np.modf(np.abs(np.sin(i * 127.1 + j * 311.7 + seed * 74.7)
                                  * 43758.5453))[0]

        n = ((h(xi, yi) * (1 - sx) + h(xi + 1, yi) * sx) * (1 - sy)
             + (h(xi, yi + 1) * (1 - sx) + h(xi + 1, yi + 1) * sx) * sy)
        out += amp * n
        amp_sum += amp
    return out / amp_sum


def _raycast_cube_scene(rays_o, rays_d, half=0.35, bg_dist=3.0, probe="cube",
                        texture="checker"):
    """Analytic render: colored probe (cube/sphere) + gradient background wall.

    Returns rgb [N, 3], depth [N], hit_mask [N].
    """
    N = rays_o.shape[0]
    rgb = np.zeros((N, 3), np.float32)
    depth = np.full(N, bg_dist, np.float32)
    # sphere-trace the probe
    t = np.zeros(N, np.float32)
    pos = rays_o.copy()
    hit = np.zeros(N, bool)
    alive = np.ones(N, bool)
    for _ in range(96):
        d = _probe_sdf(pos[alive], half, probe)
        t_alive = t[alive] + d
        newly_hit = d < 1e-4
        t[alive] = t_alive
        pos[alive] = rays_o[alive] + rays_d[alive] * t_alive[:, None]
        idx = np.where(alive)[0]
        hit[idx[newly_hit]] = True
        alive[idx[newly_hit]] = False
        alive[t > 10.0] = False
        if not alive.any():
            break
    # face colors from dominant position axis (6 colored faces on the cube,
    # 6 colored octant patches on the sphere — matchable texture either way)
    p_hit = pos[hit]
    axis = np.argmax(np.abs(p_hit), axis=-1)
    sign = np.sign(p_hit[np.arange(len(p_hit)), axis])
    face_colors = np.array([
        [0.9, 0.2, 0.2], [0.2, 0.9, 0.2], [0.2, 0.2, 0.9],
        [0.9, 0.9, 0.2], [0.9, 0.2, 0.9], [0.2, 0.9, 0.9],
    ], np.float32)
    face_id = axis * 2 + (sign > 0)
    # add a checker texture for matchable detail
    uv_axes = {0: (1, 2), 1: (0, 2), 2: (0, 1)}
    u = np.take_along_axis(p_hit, np.array([uv_axes[a][0] for a in axis])[:, None], 1)[:, 0]
    v = np.take_along_axis(p_hit, np.array([uv_axes[a][1] for a in axis])[:, None], 1)[:, 0]
    if texture == "noise":
        # distinctive per-face value noise (real-matcher protocol): two
        # decorrelated octave stacks modulate brightness + a channel tint
        nu = _value_noise(u / (2 * half) + 0.5, v / (2 * half) + 0.5,
                          seed=1.0 + face_id)
        nt = _value_noise(u / (2 * half) + 0.5, v / (2 * half) + 0.5,
                          seed=13.0 + face_id, base_freq=11.0)
        shade = (0.45 + 0.55 * nu)[:, None] * np.stack(
            [0.8 + 0.2 * nt, np.ones_like(nt), 1.0 - 0.2 * nt], -1)
        rgb[hit] = np.clip(face_colors[face_id] * shade, 0, 1)
    else:
        checker = ((np.floor(u * 8) + np.floor(v * 8)) % 2) * 0.3 + 0.7
        rgb[hit] = face_colors[face_id] * checker[:, None]
    depth[hit] = t[hit]
    # background: gradient wall at z = bg_dist plane (world z)
    miss = ~hit
    tz = (bg_dist - rays_o[miss, 2]) / np.clip(rays_d[miss, 2], 1e-6, None)
    pw = rays_o[miss] + rays_d[miss] * tz[:, None]
    rgb[miss] = np.stack([
        0.25 + 0.25 * np.sin(pw[:, 0] * 2.0),
        0.35 + 0.25 * np.sin(pw[:, 1] * 2.5 + 1.0),
        0.45 + 0.25 * np.sin((pw[:, 0] + pw[:, 1]) * 1.5),
    ], -1).astype(np.float32)
    if texture == "noise":
        # wall speckle so the SCENE matcher (corres loss) finds keypoints on
        # the background too, not just the probe silhouette
        wn = _value_noise(pw[:, 0] * 0.35, pw[:, 1] * 0.35, seed=29.0,
                          base_freq=9.0)
        rgb[miss] = np.clip(rgb[miss] * (0.55 + 0.65 * wn[:, None]), 0, 1)
    depth[miss] = tz
    return np.clip(rgb, 0, 1), depth, hit


def make_synthetic_scene(n_train: int = 3, n_test: int = 6, H: int = 64, W: int = 64,
                         cube_half: float = 0.35, seed: int = 0,
                         n_matches: int = 128,
                         arc_half: float | None = None,
                         probe: str = "cube",
                         match_source: str = "analytic",
                         matcher_device="cuda",
                         match_noise_px: float = 0.0,
                         match_outlier_frac: float = 0.0,
                         texture: str = "checker") -> base.SceneData:
    """Build the hermetic scene.

    `n_test` held-out views are evenly interleaved with a separation floor
    from the train views.

    Match realism knobs:

    * ``match_source="analytic"`` — GT-projected correspondences (exact).
    * ``match_source="classical"|"superglue"`` — the real matcher run on the
      rendered views, as the loaders match a dataset (SuperGlue's networks on
      `matcher_device`).
    * ``match_noise_px`` — i.i.d. Gaussian pixel noise added to every
      analytic match endpoint (a real matcher's localisation error).
    * ``match_outlier_frac`` — this fraction of valid matches replaced by
      uniform random in-bounds pixel pairs at full confidence (gross
      mismatches that PnP-RANSAC + the gate/rescue stack must reject).
    """
    rng = np.random.default_rng(seed)
    n_views = n_train + n_test
    f = 0.9 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    Ks = np.tile(K[None], (n_views, 1, 1))

    # cameras on an arc looking at the origin. The train views span the arc
    # and the test views sit between them (interpolation), mirroring the
    # reference's DTU protocol where test ids interleave the selected train
    # ids (`load_dtu.py:44-46`) — a test view outside the training arc would
    # measure extrapolation, which no few-shot method is scored on.
    # The arc width scales with the view count so the PER-PAIR baseline stays
    # fixed (~14 deg), like the reference's ADJACENT-view selection
    # (scan1 ids [22,25,28] are neighbouring DTU cameras, not a full sweep;
    # `configs/dtu_e2e/scan1.py:19`): 3 views -> +-0.25 rad, 6 -> +-0.5 rad.
    if arc_half is None:
        arc_half = min(0.5, 0.125 * (n_train - 1))
    train_angles = np.linspace(-arc_half, arc_half, n_train)
    if n_test > 0 and n_train > 1:
        # evenly spread the test views over the arc at half-cell offsets so
        # they interleave the train views with a guaranteed angular margin
        test_angles = (-arc_half
                       + (np.arange(n_test) + 0.5) * 2 * arc_half / n_test)
        test_angles += rng.normal(0, 0.01, n_test)
    else:
        test_angles = np.linspace(-0.4, 0.4, max(n_test, 1))[:n_test]
    angles = np.concatenate([train_angles, test_angles]) + rng.normal(0, 0.03, n_views)
    if n_test > 0 and n_train > 1:
        # post-jitter separation floor: nudge any test view that landed
        # within 0.04 rad (~2.3 deg) of a train view toward its own cell
        min_sep = 0.04
        for t in range(n_train, n_views):
            d = angles[t] - angles[:n_train]
            k = np.argmin(np.abs(d))
            if np.abs(d[k]) < min_sep:
                angles[t] = angles[k] + np.copysign(min_sep, d[k] if d[k] != 0 else 1.0)
    radius = 2.6
    images, masks, poses_w2c, depths = [], [], [], []
    for a in angles:
        cam_pos = np.array([radius * np.sin(a), 0.35 * np.sin(2 * a), -radius * np.cos(a)])
        R_c2w = _look_at(cam_pos, np.zeros(3))
        # w2c = inverse of [R|t]
        R_w2c = R_c2w.T
        t_w2c = -R_w2c @ cam_pos
        poses_w2c.append(np.concatenate([R_w2c, t_w2c[:, None]], axis=1))
        # rays (inverse_y convention, +0.5 centers)
        xs, ys = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
        dirs = np.stack([(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1], np.ones_like(xs)], -1)
        rd = dirs @ R_c2w.T
        ro = np.broadcast_to(cam_pos, rd.shape)
        rgb, depth, hit = _raycast_cube_scene(ro.reshape(-1, 3), rd.reshape(-1, 3), cube_half,
                                              probe=probe, texture=texture)
        images.append(rgb.reshape(H, W, 3))
        masks.append(hit.reshape(H, W, 1).astype(np.float32))
        depths.append(depth.reshape(H, W))

    images = np.stack(images)
    masks = np.stack(masks)
    poses_w2c = np.stack(poses_w2c).astype(np.float32)
    i_train = np.arange(n_train)
    i_test = np.arange(n_train, n_views)

    pair_j = base.default_pair_j(n_train)
    # skip pairs (i-2, i) for the match-BA pose polish (pose_init/ba.py):
    # chain pairs alone leave each pair's translation scale free
    skip_pairs = np.array([[i - 2, i] for i in range(2, n_train)], np.int32) \
        if n_train >= 3 else np.zeros((0, 2), np.int32)

    def analytic_pack(j, i, on_cube):
        """Analytic matches for views (j, i): project surface points seen in
        both views; co-visibility = first-hit agreement in BOTH depth maps (a
        real matcher only pairs mutually visible points; an occluded-in-j
        point would hand PnP a wrong 3D anchor)."""
        pack = np.zeros((n_matches, 5), np.float32)
        pts3d = _sample_visible_points(rng, n_matches * 4, cube_half, on_cube,
                                       depths[j], poses_w2c[j], K, H, W,
                                       probe=probe)

        def proj(pose, pts):
            pc = pts @ pose[:, :3].T + pose[:, 3]
            return pc[:, :2] / pc[:, 2:], pc[:, 2]

        p_j, z_j = proj(poses_w2c[j], pts3d)
        p_i, z_i = proj(poses_w2c[i], pts3d)
        px_j = p_j @ K[:2, :2].T + K[:2, 2]
        px_i = p_i @ K[:2, :2].T + K[:2, 2]
        ok = ((px_j >= 1) & (px_j <= [W - 2, H - 2])).all(1) & \
             ((px_i >= 1) & (px_i <= [W - 2, H - 2])).all(1) & \
             (z_i > 0.1) & (z_j > 0.1)
        ok &= _visible_in(px_j, z_j, depths[j]) & _visible_in(px_i, z_i, depths[i])
        sel = np.where(ok)[0][:n_matches]
        m = len(sel)
        pack[:m, 0:2] = px_j[sel]   # pixels in the paired (earlier) view
        pack[:m, 2:4] = px_i[sel]   # pixels in the current view
        pack[:m, 4] = 1.0
        return pack

    if match_source == "analytic":
        obj_matches = np.stack([analytic_pack(pair_j[i], i, True)
                                for i in range(n_train)])
        scene_matches = np.stack([analytic_pack(pair_j[i], i, False)
                                  for i in range(n_train)])
        ba_matches = np.stack([analytic_pack(j, i, False)
                               for j, i in skip_pairs]) if len(skip_pairs) else \
            np.zeros((0, n_matches, 5), np.float32)
    else:
        raise ValueError(f"unknown match_source: {match_source!r}")
    if match_noise_px > 0 or match_outlier_frac > 0:
        for packs in (obj_matches, scene_matches, ba_matches):
            corrupt_match_packs(rng, packs, H, W,
                                noise_px=match_noise_px,
                                outlier_frac=match_outlier_frac)

    samplers = base.build_semantic_samplers(masks[:n_train])
    # probe bbox sized so the cube SDF init (rect = span/(1.25*1.05)) matches
    # the true cube closely — the analog of a well-chosen DTU xyz bound, which
    # is what makes the reference's PnP anchors accurate
    margin = cube_half * 1.3125
    return base.SceneData(
        images=images, masks=masks, Ks=Ks, poses_gt_w2c=poses_w2c,
        # far must cover the background wall for *oblique* rays: the wall at
        # z=bg_dist is up to ~7 ray-units away at the image corners (the
        # reference widens near/far per dataset the same way, load_data.py:91).
        # far=6 clipped those rays and forced view-inconsistent floaters at
        # the far plane — capping held-out PSNR at ~15.5 regardless of poses.
        i_train=i_train, i_test=i_test, near=0.5, far=8.5,
        xyz_min=np.array([-margin] * 3, np.float32),
        xyz_max=np.array([margin] * 3, np.float32),
        obj_matches=obj_matches, scene_matches=scene_matches, pair_j=pair_j,
        ba_matches=ba_matches, ba_pairs=skip_pairs,
        samplers=samplers, inverse_y=True,
        # rays use the K^-1 [x, y, 1] convention (camera-z = 1), so the ray
        # parameter t IS camera-z — same convention as the scene renderer's
        # depth output, usable directly as depth-metric GT
        depth_gt=np.stack(depths).astype(np.float32),
    )


def corrupt_match_packs(rng, packs: np.ndarray, H: int, W: int,
                        noise_px: float = 0.0,
                        outlier_frac: float = 0.0) -> np.ndarray:
    """Degrade analytic match packs toward real-matcher statistics, IN PLACE.

    Models the two failure modes of a learned/classical matcher that the
    reference pipeline absorbs via PnP-RANSAC (`lib/recon_scene.py:276-310`,
    `reprojectionError=4.0` analog) and that the gate/rescue stack must
    survive:

    * localisation noise — i.i.d. Gaussian ``noise_px`` on all four pixel
      coordinates of every valid match;
    * gross outliers — ``outlier_frac`` of valid rows replaced by uniform
      random in-bounds pixel pairs, confidence left at 1.0 (RANSAC gets no
      hint; a conf-thresholding shortcut cannot hide them).

    Coordinates are clipped to the valid pixel range so downstream bilinear
    reads stay in-bounds. Returns `packs` for chaining.
    """
    n_pair = packs.shape[0]
    for i in range(n_pair):
        valid = np.where(packs[i, :, 4] > 0)[0]
        if len(valid) == 0:
            continue
        if noise_px > 0:
            packs[i, valid, 0:4] += rng.normal(0.0, noise_px, (len(valid), 4))
        if outlier_frac > 0:
            n_out = int(round(outlier_frac * len(valid)))
            if n_out > 0:
                out = rng.choice(valid, n_out, replace=False)
                packs[i, out, 0] = rng.uniform(1, W - 2, n_out)
                packs[i, out, 1] = rng.uniform(1, H - 2, n_out)
                packs[i, out, 2] = rng.uniform(1, W - 2, n_out)
                packs[i, out, 3] = rng.uniform(1, H - 2, n_out)
        packs[i, valid, 0] = np.clip(packs[i, valid, 0], 1, W - 2)
        packs[i, valid, 1] = np.clip(packs[i, valid, 1], 1, H - 2)
        packs[i, valid, 2] = np.clip(packs[i, valid, 2], 1, W - 2)
        packs[i, valid, 3] = np.clip(packs[i, valid, 3], 1, H - 2)
    return packs


def _visible_in(px: np.ndarray, z_cam: np.ndarray, depth_map: np.ndarray,
                tol: float = 0.03) -> np.ndarray:
    """True where the camera-z depth agrees with the first-hit depth map.

    depth_map stores the ray PARAMETER t of rays cast with the
    K^-1 [x, y, 1] convention — the camera-frame direction has z = 1, so t
    IS the camera z of the hit point (the SceneData.depth_gt contract).
    """
    H, W = depth_map.shape
    xi = np.clip(px[:, 0].astype(int), 0, W - 1)
    yi = np.clip(px[:, 1].astype(int), 0, H - 1)
    z_map = depth_map[yi, xi]
    return np.abs(z_cam - z_map) < tol * np.maximum(z_map, 1.0)


def _sample_visible_points(rng, n, cube_half, on_cube, depth_j, pose_j, K, H, W,
                           probe="cube"):
    """3D points visible in view j: on the probe surface or on the background."""
    if on_cube and probe == "sphere":
        # uniform directions scaled to the sphere surface
        v = rng.normal(size=(n, 3))
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
        return v * cube_half
    if on_cube:
        # random points on cube faces
        face = rng.integers(0, 6, n)
        uv = rng.uniform(-cube_half, cube_half, (n, 2))
        pts = np.zeros((n, 3))
        for k in range(n):
            ax, sg = face[k] // 2, (face[k] % 2) * 2 - 1
            other = [a for a in range(3) if a != ax]
            pts[k, ax] = sg * cube_half
            pts[k, other[0]] = uv[k, 0]
            pts[k, other[1]] = uv[k, 1]
        return pts
    # background points: unproject random pixels of view j at their depth
    ys = rng.integers(2, H - 2, n)
    xs = rng.integers(2, W - 2, n)
    z = depth_j[ys, xs]
    cam = np.stack([(xs + 0.5 - K[0, 2]) / K[0, 0] * z, (ys + 0.5 - K[1, 2]) / K[1, 1] * z, z], -1)
    R, t = pose_j[:, :3], pose_j[:, 3]
    return (cam - t) @ R  # R^T inverse rotation (R is w2c)


def camera_rig(n_train: int = 3, n_test: int = 1, H: int = 64, W: int = 64, seed: int = 0,
               arc_half: float | None = None) -> tuple[np.ndarray, np.ndarray]:
    """The cameras `make_synthetic_scene` places for the same arguments, without
    ray-casting a view: (poses_w2c [n_views, 3, 4] float32, Ks [n_views, 3, 3]),
    train views first."""
    rng = np.random.default_rng(seed)
    n_views = n_train + n_test
    f = 0.9 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    if arc_half is None:
        arc_half = min(0.5, 0.125 * (n_train - 1))
    train_angles = np.linspace(-arc_half, arc_half, n_train)
    if n_test > 0 and n_train > 1:
        test_angles = -arc_half + (np.arange(n_test) + 0.5) * 2 * arc_half / n_test
        test_angles += rng.normal(0, 0.01, n_test)
    else:
        test_angles = np.linspace(-0.4, 0.4, max(n_test, 1))[:n_test]
    angles = np.concatenate([train_angles, test_angles]) + rng.normal(0, 0.03, n_views)
    if n_test > 0 and n_train > 1:
        for t in range(n_train, n_views):
            d = angles[t] - angles[:n_train]
            k = np.argmin(np.abs(d))
            if np.abs(d[k]) < 0.04:
                angles[t] = angles[k] + np.copysign(0.04, d[k] if d[k] != 0 else 1.0)
    poses = []
    for a in angles:
        cam_pos = np.array([2.6 * np.sin(a), 0.35 * np.sin(2 * a), -2.6 * np.cos(a)])
        R_w2c = _look_at(cam_pos, np.zeros(3)).T
        poses.append(np.concatenate([R_w2c, (-R_w2c @ cam_pos)[:, None]], axis=1))
    return np.stack(poses).astype(np.float32), np.tile(K[None], (n_views, 1, 1))
