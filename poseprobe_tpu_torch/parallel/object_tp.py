"""The object branch's training step, and the joint step, with Z-sharded
(tensor-parallel) voxel grids.

Port of `poseprobe_tpu/parallel/object_tp.py`. `grid_tp.py` holds the sharded
primitives; this module strings them into the object branch's pipeline --
dense ray sampling, the SDF lookup, NeuS alpha (`ops/compositing.py`),
transmittance compositing, colour from the feature grid, the masked MSE and
mask BCE -- with gradients into the sharded grids, on a 2-D
``('data', 'grid')`` mesh: rays data-parallel, grids tensor-parallel. It is
the capacity path for grids too large for one card's memory (a 192^3+ probe
grid); the trainer keeps replicated grids, the fast path at 96^3.

Each rank takes its share of the rays along the data axis (a `pcast` and a
slice, so a ray's gradient sums over the ranks that used it), renders them
through the sharded sampler, and the per-ray outputs are gathered to every
rank (`collectives.all_gather`, whose backward takes this rank's slice of the
cotangent), so that every rank computes the same full loss; the grids' and
the replicated parameters' gradients then come out whole on every rank
(`parallel/collectives.py`). The SDF's spatial gradient is a central
difference at half a voxel through the same sharded sampler, so every grid
read crosses the halo. The update is plain SGD on each rank's slabs and
replicas; nothing is gathered to the host. With ``mesh=None`` the same
functions are the unsharded steps on whole grids.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tree import tree_leaves, tree_map, tree_unflatten
from ..ops import compositing
from . import grid_tp
from .collectives import Mesh, all_gather, pcast, psum
from .mesh import DATA_AXIS

LR = 1e-2                                  # the SGD step of both steps


def _rays_of_rank(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """This rank's share along dim 0 of rays that every rank holds whole."""
    if mesh is None:
        return x
    axis = mesh.axis(DATA_AXIS)
    n = x.shape[0]
    if n % axis.size:
        raise ValueError(f"{n} rays do not divide over the data axis of size {axis.size}")
    return pcast(x, mesh, axis).narrow(0, axis.index * (n // axis.size), n // axis.size)


def _all_rays(xs: list, mesh: Mesh | None) -> list:
    """The per-ray outputs of every rank's share, whole on every rank."""
    if mesh is None:
        return list(xs)
    return all_gather(xs, mesh, mesh.axis(DATA_AXIS), [0] * len(xs))


def _norm(g: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The L2 norm of a whole grid's gradient from this rank's slab of it."""
    sq = (g * g).sum()
    if mesh is not None:
        sq = psum(sq, mesh, mesh.axis(grid_tp.GRID_AXIS))
    return torch.sqrt(sq)


def render_rays_tp(sdf_grid: torch.Tensor, k0_grid: torch.Tensor, rays_o: torch.Tensor,
                   rays_d: torch.Tensor, near: float, far: float, n_samples: int,
                   xyz_min, xyz_max, s_val: float, mesh: Mesh | None) -> dict:
    """Dense [R, S] object render of this rank's rays with both grids
    Z-sharded: sdf_grid [1, X, Y, Zl], k0_grid [C, X, Y, Zl] (this rank's
    slabs); rays_* [R, 3], this rank's share along the data axis."""
    dt, dev = rays_o.dtype, rays_o.device
    t = torch.linspace(near, far, n_samples, dtype=dt, device=dev)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * t[None, :, None]          # [R, S, 3]
    dist = float((far - near) / (n_samples - 1))
    lo = torch.as_tensor(xyz_min, dtype=dt, device=dev)
    hi = torch.as_tensor(xyz_max, dtype=dt, device=dev)

    def sample_sdf(p):
        return grid_tp.sample_grid_tp(sdf_grid, p, lo, hi, mesh, data_sharded_points=True)[..., 0]

    sdf = sample_sdf(pts)
    n_grid = 1 if mesh is None else mesh.shape[grid_tp.GRID_AXIS]
    full = np.asarray((*sdf_grid.shape[1:3], sdf_grid.shape[3] * n_grid))
    vox = (np.asarray(xyz_max) - np.asarray(xyz_min)) / (full - 1)
    eps = float(vox.min()) * 0.5
    eye = torch.eye(3, dtype=dt, device=dev)
    grads = torch.stack([(sample_sdf(pts + eye[a] * eps) - sample_sdf(pts - eye[a] * eps)) / (2 * eps)
                         for a in range(3)], dim=-1)                           # [R, S, 3]
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    alpha = compositing.neus_alpha_from_sdf(viewdirs[:, None, :], dist, sdf, grads, s_val)
    # out-of-box samples contribute nothing (dense layout, masked, not regathered)
    inb = torch.all((pts >= lo) & (pts <= hi), dim=-1)
    alpha = torch.where(inb, alpha, 0.0)
    weights, _ = compositing.alpha2weights(alpha)
    feat = grid_tp.sample_grid_tp(k0_grid, pts, lo, hi, mesh, data_sharded_points=True)
    rgb = torch.sigmoid(feat[..., :3])
    return {"rgb_marched": (weights[..., None] * rgb).sum(dim=1), "depth": (weights * t[None, :]).sum(dim=1),
            "opacity": weights.sum(dim=1), "sdf": sdf, "weights": weights}


def train_step_tp(sdf_grid, k0_grid, rays_o, rays_d, target_rgb, target_mask, near, far, n_samples,
                  xyz_min, xyz_max, s_val, mesh: Mesh | None):
    """One SGD step of the sharded object branch on rays [R, 3] and targets
    (rgb [R, 3], mask [R]) that every rank holds whole; returns (new sdf slab,
    new k0 slab, metrics). Loss = masked render MSE + 0.01 mask BCE on the
    opacity (the object branch's two primary terms)."""
    sdf_grid, k0_grid = (g.detach().requires_grad_(True) for g in (sdf_grid, k0_grid))
    out = render_rays_tp(sdf_grid, k0_grid, _rays_of_rank(rays_o, mesh), _rays_of_rank(rays_d, mesh),
                         near, far, n_samples, xyz_min, xyz_max, s_val, mesh)
    rgb, opacity = _all_rays([out["rgb_marched"], out["opacity"]], mesh)
    mse = ((rgb - target_rgb) ** 2).mean()
    op = torch.clamp(opacity, 1e-6, 1 - 1e-6)
    bce = -(target_mask * torch.log(op) + (1 - target_mask) * torch.log(1 - op)).mean()
    loss = mse + 0.01 * bce
    g_sdf, g_k0 = torch.autograd.grad(loss, [sdf_grid, k0_grid])
    with torch.no_grad():
        metrics = {"loss": loss.detach(), "mse": mse.detach(), "bce": bce.detach(),
                   "grad_sdf_norm": _norm(g_sdf, mesh), "grad_k0_norm": _norm(g_k0, mesh)}
        return sdf_grid.detach() - LR * g_sdf, k0_grid.detach() - LR * g_k0, metrics


def joint_step_tp(params: dict, cfg_scene, rays_cam, base_w2c, targets, masks, near, far, n_samples,
                  xyz_min, xyz_max, s_val, progress, mesh: Mesh | None):
    """One joint SGD step with Z-sharded grids: the object branch through the
    sharded samplers, the coarse scene NeRF (`models/scene_nerf.render_rays`,
    the fused trunk at ``matmul_dtype="bfloat16"`` on the card) on the same
    rays, and the se3 refinement deltas composed onto `base_w2c` inside the
    step, so ray generation is differentiated and the poses take gradients
    from both branches.

    params: {"sdf" [1, X, Y, Zl] and "k0" [C, X, Y, Zl] (this rank's slabs),
    "scene" (param tree), "se3" [V, 6]}, the last two replicated.
    rays_cam: [V, R, 3] camera-frame ray directions (K^-1 [x, y, 1]);
    targets / masks: [V, R, 3] / [V, R]. V * R must divide over the data
    axis. Returns (new params, metrics)."""
    from ..core import lie, pose as pose_ops
    from ..models import scene_nerf

    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    p = tree_unflatten(params, leaves)
    w2c = pose_ops.compose_pair(base_w2c, lie.se3_to_SE3(p["se3"]))            # [V, 3, 4]
    R_c2w = w2c[:, :, :3].transpose(1, 2)
    t_c2w = -torch.einsum("vij,vj->vi", R_c2w, w2c[:, :, 3])
    rd = torch.einsum("vij,vrj->vri", R_c2w, rays_cam)                       # [V, R, 3]
    ro = t_c2w[:, None, :].expand(rd.shape)
    ro_l, rd_l = _rays_of_rank(ro.reshape(-1, 3), mesh), _rays_of_rank(rd.reshape(-1, 3), mesh)
    obj = render_rays_tp(p["sdf"], p["k0"], ro_l, rd_l, near, far, n_samples, xyz_min, xyz_max, s_val, mesh)
    scene_p = p["scene"] if mesh is None else tree_map(lambda t: pcast(t, mesh, mesh.axis(DATA_AXIS)), p["scene"])
    scene = scene_nerf.render_rays(scene_p, cfg_scene, ro_l[None], rd_l[None], (near, far), progress,
                                   noise=None, compute_fine=False)
    marched, opacity, rgb_scene = _all_rays([obj["rgb_marched"], obj["opacity"], scene["rgb"][0]], mesh)
    tgt, msk = targets.reshape(-1, 3), masks.reshape(-1)
    mse_obj = (msk[:, None] * (marched - tgt) ** 2).sum() / (3 * msk.sum() + 1e-8)
    op = torch.clamp(opacity, 1e-6, 1 - 1e-6)
    bce = -(msk * torch.log(op) + (1 - msk) * torch.log(1 - op)).mean()
    mse_scene = ((rgb_scene - tgt) ** 2).mean()
    loss = mse_obj + 0.01 * bce + mse_scene
    grads = [torch.zeros_like(x) if gx is None else gx     # the fine network takes no gradient here
             for x, gx in zip(leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
    g = tree_unflatten(params, list(grads))
    with torch.no_grad():
        new = tree_unflatten(params, [x.detach() - LR * gx for x, gx in zip(leaves, grads)])
        metrics = {"loss": loss.detach(), "mse_obj": mse_obj.detach(), "bce": bce.detach(),
                   "mse_scene": mse_scene.detach(), "grad_sdf_norm": _norm(g["sdf"], mesh),
                   "grad_se3_norm": torch.linalg.norm(g["se3"])}
    return new, metrics
