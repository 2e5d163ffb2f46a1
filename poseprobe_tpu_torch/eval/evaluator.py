"""Final evaluation: pose alignment, test-time pose optimization, the
fixed-ray photometric score, the chunked full-image render and the full
test-set evaluation.

Port of `poseprobe_tpu/eval/evaluator.py`: `align_train_poses`,
`test_time_pose_optim`, `photometric_pose_score`, `render_full` and
`evaluate_full` (align the optimized train poses to GT; for each test view,
map its GT pose into the optimized frame through the inverse sim3, optimize
a per-image se3 refinement photometrically, render the full image; report
PSNR / SSIM (/ LPIPS where its weights are present), depth errors and the
train poses' rotation / translation errors). The image metrics are in
`eval/metrics.py`; the panels are written by the port's PNG writer.

Random draws are injected: `test_time_pose_optim` takes the ray indices of
every iteration (`ray_idx` [n_iters, rand_rays]), `evaluate_full` those of
each test image, and `photometric_pose_score` its fixed ray subset
(`ray_idx` [n]); when the caller passes none they are drawn from a
`torch.Generator` seeded with `seed` (the test image's index in
`evaluate_full`), so a pose score stays comparable between two poses of one
view.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from ..core import align, lie, pose as pose_ops, rays as rays_mod
from ..core.tree import tree_leaves
from ..data.png import write_png
from ..models import scene_nerf
from ..parallel import mesh as mesh_mod
from ..train.optim import _Adam
from ..utils.profiling import span
from . import metrics as metrics_mod


def align_train_poses(pose_w2c, pose_GT_w2c):
    """Pose alignment (host float64); pairwise variant for small camera
    systems (fewer than 10 views). Returns (aligned w2c [N, 3, 4], Sim3)."""
    pose_w2c, pose_GT_w2c = _to_numpy(pose_w2c), _to_numpy(pose_GT_w2c)
    if pose_w2c.shape[0] < 10:
        return align.prealign_w2c_small_camera_systems(pose_w2c, pose_GT_w2c)
    return align.prealign_w2c_large_camera_systems(pose_w2c, pose_GT_w2c)


def _to_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _on(device, *arrays) -> list:
    """Arrays or tensors -> float32 tensors on `device` (a tensor already there is not copied)."""
    return [a.detach().to(device, torch.float32) if isinstance(a, torch.Tensor)
            else torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device) for a in arrays]


def _pixels_of(ray_idx: torch.Tensor, W: int) -> torch.Tensor:
    return torch.stack([(ray_idx % W).to(torch.float32),
                        torch.div(ray_idx, W, rounding_mode="floor").to(torch.float32)], dim=-1)


def test_time_pose_optim(
    scene_params: dict,
    scene_cfg: scene_nerf.SceneConfig,
    pose_w2c_init,                # [3, 4] test pose mapped into the optimized frame
    K,
    image,                        # [H, W, 3]
    depth_range,
    n_iters: int = 100,
    lr: float = 1e-3,
    rand_rays: int = 1024,
    seed: int = 0,
    progress: float = 1.0,
    use_fine: bool | None = None,
    rot_only: bool = False,
    center_anchor: float = 0.0,
    ray_idx=None,
) -> torch.Tensor:
    """Optimize a per-image se3 refinement photometrically with Adam.

    Also reused by the trainer as an activation-time pose warmup (align a
    newly activated view against the current scene before joint training
    touches it); pass `use_fine=False` before the fine phase starts.

    `rot_only=True` zeroes the translation tangent so the refine is a pure
    rotation in w2c composition, which keeps the camera center invariant
    (C = -R^T t is unchanged by [R_r|0] o [R|t]): a warmup against a blurry
    early render reliably fixes orientation but injects along-view-axis
    translation error.

    `center_anchor > 0` is the soft version of the same idea: a penalty
    ``center_anchor * ||C(pose) - C(init)||^2`` on the camera-center
    displacement from the seed.

    `ray_idx` [n_iters, rand_rays]: flat pixel indices of every iteration
    (None: drawn from a generator seeded with `seed`).
    """
    if use_fine is None:
        use_fine = scene_cfg.fine_sampling
    device = tree_leaves(scene_params)[0].device
    pose_w2c_init, K, image = _on(device, pose_w2c_init, K, image)
    H, W = image.shape[:2]
    img_flat = image.reshape(-1, 3)
    if ray_idx is None:
        gen = torch.Generator().manual_seed(seed)
        ray_idx = torch.randint(0, H * W, (n_iters, rand_rays), generator=gen)
    ray_idx = torch.as_tensor(np.asarray(ray_idx), dtype=torch.int64, device=device)

    def compose(se3):
        refine = lie.se3_to_SE3(se3)[0]
        # rot_only: camera-side composition (refine after world->cam), so a
        # zero-translation refine keeps the camera center exactly; the default
        # is the world-side refine
        return (pose_ops.compose_pair(pose_w2c_init, refine) if rot_only
                else pose_ops.compose_pair(refine, pose_w2c_init))

    se3 = torch.zeros((1, 6), dtype=torch.float32, device=device)
    adam = _Adam(0.9, 0.999)
    state = adam.init([se3])
    for it in range(n_iters):
        leaf = se3.detach().requires_grad_(True)
        pose = compose(leaf)
        center, ray = rays_mod.get_center_and_ray_at_pixels(pose[None], _pixels_of(ray_idx[it], W),
                                                            K[None])
        rets = scene_nerf.render_rays(scene_params, scene_cfg, center, ray, depth_range,
                                      progress=progress, noise=None, compute_fine=use_fine)
        rgb = rets.get("rgb_fine", rets["rgb"])
        loss = ((rgb[0] - img_flat[ray_idx[it]]) ** 2).mean()
        if center_anchor > 0:
            c_new = -pose[:3, :3].T @ pose[:3, 3]
            c_init = -pose_w2c_init[:3, :3].T @ pose_w2c_init[:3, 3]
            loss = loss + center_anchor * torch.sum((c_new - c_init) ** 2)
        g, = torch.autograd.grad(loss, leaf)
        if rot_only:
            g = torch.cat([g[..., :3], torch.zeros_like(g[..., 3:])], dim=-1)   # se3 = [w | u]; freeze u
        d = adam._direction([g], state)
        se3 = se3 - lr * d[0]
    with torch.no_grad():
        return compose(se3)


def photometric_pose_score(scene_params, scene_cfg, pose_w2c, K, image, depth_range,
                           rand_rays: int = 2048, seed: int = 17, progress: float = 1.0,
                           use_fine: bool | None = None, ray_idx=None) -> float:
    """Photometric MSE of `pose_w2c` against `image` on a fixed ray subset.

    Deterministic (fixed seed, or the caller's `ray_idx` [n] of distinct flat
    pixel indices) so two poses for the same view are directly comparable --
    used by the trainer's activation gate to detect PnP poses that reproject
    tightly but are geometrically degenerate, and to accept a warmup result
    only when it actually helps."""
    if use_fine is None:
        use_fine = scene_cfg.fine_sampling
    device = tree_leaves(scene_params)[0].device
    pose_w2c, K, image = _on(device, pose_w2c, K, image)
    H, W = image.shape[:2]
    if ray_idx is None:
        gen = torch.Generator().manual_seed(seed)
        ray_idx = torch.randperm(H * W, generator=gen)[:min(rand_rays, H * W)]
    ray_idx = torch.as_tensor(np.asarray(ray_idx), dtype=torch.int64, device=device)
    with torch.no_grad():
        center, ray = rays_mod.get_center_and_ray_at_pixels(pose_w2c[None], _pixels_of(ray_idx, W),
                                                            K[None])
        rets = scene_nerf.render_rays(scene_params, scene_cfg, center, ray, depth_range,
                                      progress=progress, noise=None, compute_fine=use_fine)
        rgb = rets.get("rgb_fine", rets["rgb"])
        return float(((rgb[0] - image.reshape(-1, 3)[ray_idx]) ** 2).mean())


def render_full(scene_params, scene_cfg, pose_w2c, K, H: int, W: int, depth_range,
                chunk: int = 4096, use_fine: bool | None = None, progress: float = 1.0,
                mesh=None) -> dict:
    """Chunked full-image render: {'rgb', 'depth', 'depth_var', 'opacity'}, each [H, W, C].
    With a ('data',) `mesh` each rank renders its share of every chunk's rays
    (`parallel/mesh.shard_rays`; a chunk that does not divide is rendered
    whole) and every rank returns the whole image.

    `progress` must match the training progress of the state being rendered:
    BARF's coarse-to-fine PE masks zero the high-frequency bands during
    training, so their MLP input weights are still at init until the c2f
    window closes -- rendering a mid-training state at progress = 1.0 injects
    untrained-band garbage.

    For a profiler it marks the pixel grid and rays (`poseprobe.render.rays`),
    each chunk (`poseprobe.render.chunk`) and the final gather
    (`poseprobe.render.gather`) as spans.
    """
    if use_fine is None:
        use_fine = scene_cfg.fine_sampling
    device = tree_leaves(scene_params)[0].device
    suffix = "_fine" if use_fine else ""
    outs = {"rgb": [], "depth": [], "depth_var": [], "opacity": []}
    with torch.no_grad():
        with span("poseprobe.render.rays"):
            pose_w2c, K = _on(device, pose_w2c, K)
            ys, xs = torch.meshgrid(torch.arange(H, device=device, dtype=torch.float32),
                                    torch.arange(W, device=device, dtype=torch.float32), indexing="ij")
            pixels = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)
            center, ray = rays_mod.get_center_and_ray_at_pixels(pose_w2c[None], pixels, K[None])
        for c in range(0, H * W, chunk):
            with span("poseprobe.render.chunk"):
                cs, rs = center[:, c:c + chunk], ray[:, c:c + chunk]
                rets = scene_nerf.render_rays(scene_params, scene_cfg, mesh_mod.shard_rays(cs, mesh, axis=1),
                                              mesh_mod.shard_rays(rs, mesh, axis=1), depth_range,
                                              progress=progress, noise=None, compute_fine=use_fine)
                rets = mesh_mod.unshard_rays({k: rets[k + suffix] for k in outs}, cs.shape[1], mesh, axis=1)
                for k in outs:
                    outs[k].append(rets[k])
        with span("poseprobe.render.gather"):
            return {k: torch.cat(v, dim=1).reshape(H, W, -1) for k, v in outs.items()}


def evaluate_full(
    scene_params: dict,
    scene_cfg: scene_nerf.SceneConfig,
    train_pose_w2c,                  # [B, 3, 4] optimized
    train_pose_GT_w2c,               # [B, 3, 4]
    test_images: np.ndarray,         # [T, H, W, 3]
    test_pose_GT_w2c,                # [T, 3, 4]
    test_Ks,                         # [T, 3, 3]
    depth_range,
    test_photo: bool = True,
    test_iter: int = 100,
    lr_pose: float = 1e-3,
    save_dir: str | None = None,
    progress: float = 1.0,
    test_depth_gt: np.ndarray | None = None,  # [T, H, W] camera-z, 0 = invalid
    ray_idx=None,
) -> dict[str, Any]:
    """Full test-set evaluation; returns the reference's result dict:
    `rot_error` / `trans_error` of the aligned train poses, `psnr` and `ssim`
    mean, median and per image, `lpips` where its weights are present, and
    `depth_abs` / `depth_rmse` (the rendered depth scaled by the alignment's
    sim3.s) where GT depth is given.

    `ray_idx`: per test image, the flat pixel indices of every test-time
    iteration ([test_iter, 1024] each), or None to draw them from a generator
    seeded with the image's index. With `save_dir`, writes each image's
    gt | pred | depth | opacity panel as ``test_%03d.png``."""
    from ..utils.vis import validation_panel

    aligned, sim3 = align_train_poses(train_pose_w2c, train_pose_GT_w2c)
    err = align.evaluate_camera_alignment(aligned, _to_numpy(train_pose_GT_w2c))
    device = tree_leaves(scene_params)[0].device
    test_pose_GT_w2c, test_Ks = _to_numpy(test_pose_GT_w2c), _to_numpy(test_Ks)
    H, W = test_images.shape[1:3]
    psnrs, ssims, lpips_vals, depth_abs, depth_rmse = [], [], [], [], []
    for t in range(test_images.shape[0]):
        pose = align.backtrack_from_aligning_the_trajectory(test_pose_GT_w2c[t:t + 1], sim3)[0]
        if test_photo:
            pose = test_time_pose_optim(scene_params, scene_cfg, pose, test_Ks[t], test_images[t],
                                        depth_range, n_iters=test_iter, lr=lr_pose, seed=t,
                                        progress=progress,
                                        ray_idx=None if ray_idx is None else ray_idx[t])
        out = render_full(scene_params, scene_cfg, pose, test_Ks[t], H, W, depth_range,
                          progress=progress)
        gt = _on(device, test_images[t])[0]
        psnrs.append(float(metrics_mod.psnr(out["rgb"], gt)))
        ssims.append(float(metrics_mod.ssim(out["rgb"], gt)))
        if metrics_mod.lpips_available():
            lpips_vals.append(metrics_mod.lpips_fn(out["rgb"], gt))
        if test_depth_gt is not None:
            a, r = metrics_mod.depth_abs_rmse(out["depth"], test_depth_gt[t], scale=sim3.s)
            depth_abs.append(a)
            depth_rmse.append(r)
        if save_dir is not None:
            os.makedirs(save_dir, exist_ok=True)
            panel = validation_panel(np.asarray(test_images[t]), _to_numpy(out["rgb"]),
                                     _to_numpy(out["depth"]), _to_numpy(out["opacity"][..., 0]))
            write_png(os.path.join(save_dir, f"test_{t:03d}.png"), panel)

    results = {
        "rot_error": float(err["R"].mean()),
        "trans_error": float(err["t"].mean()),
        "psnr": float(np.mean(psnrs)),
        # the median beside the mean: one near-degenerate test view can move the mean
        "psnr_median": float(np.median(psnrs)),
        "ssim": float(np.mean(ssims)),
        "ssim_median": float(np.median(ssims)),
        "psnr_per_img": psnrs,
        "ssim_per_img": ssims,
    }
    if lpips_vals:
        results["lpips"] = float(np.mean(lpips_vals))
    if depth_abs:
        results["depth_abs"] = float(np.nanmean(depth_abs))
        results["depth_rmse"] = float(np.nanmean(depth_rmse))
        results["depth_abs_per_img"] = depth_abs
    return results
