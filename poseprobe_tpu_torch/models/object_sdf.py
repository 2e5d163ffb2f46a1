"""Object branch: dense voxel-SDF pose probe with deformation and a color head.

Port of `poseprobe_tpu/models/object_sdf.py`: a cube-initialised SDF grid, a
feature grid k0 with a shallow color MLP, the learned mapping
``sdf' = softplus(a) * (sigmoid(softplus(b) * sdf) - 0.5)``, the implicit
deformation field, NeuS alpha compositing with the s-schedule, and surface
localisation by SDF zero crossing or by rendered depth.

Rendering works on dense [n_rays, n_samples] tensors with an in-box mask
(compacted to a fixed budget under a mask cache). Every grid lookup goes
through `ops/grid.py`'s trilinear sampler, i.e. through the hand-written
kernels on the card. Random draws are injected (`jitter` [n_rays, 1]).

With ``use_pallas_composite=True`` (the reference's name for the switch) the
compositing tail of `render` -- NeuS alpha, transmittance, weights and the
per-ray colour and step sums -- runs through `ops/fused_composite.py`, i.e.
through its hand-written forward and backward kernels on the card.

The mesh helpers `extract_sdf_volume` (the dense -SDF volume that
`eval/mesh.py` meshes) and `mesh_color_forward` (vertex colours) run their
lookups through the same kernels.

The feature grid k0 is dense ([C, X, Y, Z], ``grid_type="dense"``) or the
VM-decomposed TensoRF grid (``"tensorf"``, a dict of planes and vectors,
`ops/tensorf.py`). The SDF grid is dense either way. With a dense k0 the SDF
and k0 lookups at the sample points merge into one 13-channel lookup; with
TensoRF the SDF goes through the 1-channel lookups and k0 through
`tensorf_sample`.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..core.graphsafe import const
from ..ops import compositing, fused_composite, grid as grid_ops, maskcache, pe, ray_sampling, tensorf
from . import deform as deform_mod
from .mlp import apply_mlp, init_mlp


def safe_norm(x, dim=-1, keepdim=False, eps=1e-12):
    """Norm with a NaN-free gradient at x = 0."""
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim) + eps)


@dataclasses.dataclass(frozen=True)
class ObjectConfig:
    """Static configuration of the object branch (hashable)."""

    xyz_min: tuple = (-0.6, -0.6, -0.75)
    xyz_max: tuple = (0.6, 0.6, 0.45)
    num_voxels: int = 96**3
    num_voxels_base: int = 96**3
    # color head
    rgbnet_dim: int = 12
    rgbnet_depth: int = 4
    rgbnet_width: int = 128
    rgbnet_direct: bool = True
    posbase_pe: int = 5
    viewbase_pe: int = 1
    geo_rgb_dim: int = 3
    # NeuS s schedule
    s_ratio: float = 50.0
    s_start: float = 0.2
    s_learn: bool = False
    step_start: int = 0
    # sampling
    stepsize: float = 1.5
    grid_type: str = "dense"          # k0 backend: "dense" | "tensorf"
    tensorf_n_comp: int = 24
    # pose/barf
    barf_c2f: tuple | None = (0.6, 1.0)
    N_iters: int = 10000
    # smoothing conv over the sdf grid before sampling (0 = off)
    smooth_ksize: int = 0
    smooth_sigma: float = 0.8
    # cap on the learned beta of the sigmoid SDF mapping (0 = off)
    beta_cap: float = 0.0
    world_bound_scale: float = 1.05
    fast_color_thres: float = 0.0
    # the fused alpha-composite kernel (ops/fused_composite.py)
    use_pallas_composite: bool = False
    # free-space skipping (ops/maskcache.py)
    use_maskcache: bool = False
    maskcache_thres: float = 0.05
    maskcache_sigma: float = 3.0
    maskcache_keep: float = 0.5
    maskcache_dilate: int = 3

    @property
    def xyz_min_np(self):
        return np.asarray(self.xyz_min, np.float32)

    @property
    def xyz_max_np(self):
        return np.asarray(self.xyz_max, np.float32)

    @property
    def voxel_size(self) -> float:
        return float((np.prod(self.xyz_max_np - self.xyz_min_np) / self.num_voxels) ** (1 / 3))

    @property
    def voxel_size_base(self) -> float:
        return float((np.prod(self.xyz_max_np - self.xyz_min_np) / self.num_voxels_base) ** (1 / 3))

    @property
    def world_size(self) -> tuple:
        return tuple(int(v) for v in (self.xyz_max_np - self.xyz_min_np) / self.voxel_size)

    @property
    def n_samples(self) -> int:
        return ray_sampling.n_samples_for_grid(self.world_size, self.stepsize)

    @property
    def maskcache_K(self) -> int:
        """Per-ray sample budget after free-space compaction."""
        return max(1, int(np.ceil(self.maskcache_keep * self.n_samples)))

    @property
    def rect_size(self) -> np.ndarray:
        return (self.xyz_max_np - self.xyz_min_np) / (self.world_bound_scale * 1.05)

    @property
    def range_shape_max(self) -> float:
        return float(self.rect_size.max())

    @property
    def diagonal_length(self) -> float:
        # sqrt(sum(xyz_max - xyz_min**2)): the reference's formula, an apparent
        # typo kept for parity since it scales the near-surface loss threshold
        return float(np.sqrt(np.sum(self.xyz_max_np - self.xyz_min_np**2)))

    def rgbnet_in_dim(self) -> int:
        d = 3 + 3 * self.posbase_pe * 2 + 3 + 3 * self.viewbase_pe * 2
        d += self.rgbnet_dim if self.rgbnet_direct else self.rgbnet_dim - 3
        d += self.geo_rgb_dim
        return d


def _grid_axes(cfg: ObjectConfig):
    X, Y, Z = cfg.world_size
    xs = np.linspace(cfg.xyz_min[0], cfg.xyz_max[0], X)
    ys = np.linspace(cfg.xyz_min[1], cfg.xyz_max[1], Y)
    zs = np.linspace(cfg.xyz_min[2], cfg.xyz_max[2], Z)
    return np.meshgrid(xs, ys, zs, indexing="ij")


def cube_sdf_init(cfg: ObjectConfig) -> np.ndarray:
    """Signed distance to an axis-aligned box, negative inside, with the
    reference's mirrored-plane distance formula. [1, X, Y, Z] float32."""
    x, y, z = _grid_axes(cfg)
    rect = cfg.rect_size
    center = (cfg.xyz_max_np + cfg.xyz_min_np) / 2
    dist_x = np.minimum(np.abs(x - (rect[0] / 2 - center[0])), np.abs(x - (rect[0] / 2 + center[0])))
    dist_y = np.minimum(np.abs(y - (rect[1] / 2 - center[1])), np.abs(y - (rect[1] / 2 + center[1])))
    dist_z = np.minimum(np.abs(z - (rect[2] / 2 - center[2])), np.abs(z - (rect[2] / 2 + center[2])))
    sdf = np.sqrt(dist_x**2 + dist_y**2 + dist_z**2)
    inside = (
        (x >= center[0] - rect[0] / 2) & (x <= center[0] + rect[0] / 2)
        & (y >= center[1] - rect[1] / 2) & (y <= center[1] + rect[1] / 2)
        & (z >= center[2] - rect[2] / 2) & (z <= center[2] + rect[2] / 2)
    )
    sdf[inside] *= -1
    return sdf[None].astype(np.float32)


def init_k0_grid(generator: torch.Generator, cfg: ObjectConfig, device="cuda"):
    """The feature grid: zeros [C, X, Y, Z], or TensoRF planes and vectors
    drawn from `generator`."""
    if cfg.grid_type == "tensorf":
        return tensorf.init_tensorf_params(generator, cfg.rgbnet_dim, cfg.world_size,
                                           cfg.tensorf_n_comp, device=device)
    return torch.zeros((cfg.rgbnet_dim,) + tuple(cfg.world_size), dtype=torch.float32, device=device)


def sample_k0(params: dict, cfg: ObjectConfig, pts, lo, hi):
    """k0 features at world points [..., 3] -> [..., C], for either backend."""
    if cfg.grid_type == "tensorf":
        return tensorf.tensorf_sample(params["k0_grid"], pts, lo, hi)
    return grid_ops.trilinear_sample(params["k0_grid"], pts, lo, hi)


def init_object_params(generator: torch.Generator, cfg: ObjectConfig, device="cuda") -> dict:
    dims = [cfg.rgbnet_in_dim()] + [cfg.rgbnet_width] * (cfg.rgbnet_depth - 1) + [3]
    rgbnet = init_mlp(generator, dims, scheme="torch")
    rgbnet[-1]["b"] = torch.zeros_like(rgbnet[-1]["b"])     # final bias zero
    scalar = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
    return {
        "sdf_grid": torch.as_tensor(cube_sdf_init(cfg), device=device),
        "k0_grid": init_k0_grid(generator, cfg, device),
        "rgbnet": [{k: v.to(device) for k, v in la.items()} for la in rgbnet],
        "warpnet": deform_mod.init_deform_params(generator, cfg.range_shape_max, device),
        "sdf_alpha": scalar(10.0),
        "sdf_beta": scalar(2.0),
        "s_val": scalar(cfg.s_start),
    }


def maskout_near_cam_vox(params: dict, cfg: ObjectConfig, cam_o: np.ndarray, near: float) -> dict:
    """Set SDF = 1 (empty) on voxels within `near` of any camera."""
    X, Y, Z = cfg.world_size
    gx, gy, gz = _grid_axes(cfg)
    grid_xyz = np.stack([gx, gy, gz], -1).reshape(-1, 3)
    d = np.linalg.norm(grid_xyz[:, None, :] - np.asarray(cam_o)[None], axis=-1).min(1)
    sdf = params["sdf_grid"].detach().cpu().numpy().reshape(-1)
    sdf = np.where(d <= near, 1.0, sdf).reshape(1, X, Y, Z).astype(np.float32)
    return {**params, "sdf_grid": torch.as_tensor(sdf, device=params["sdf_grid"].device)}


def softplus10(x):
    """nn.Softplus(beta=10), as used for sdf_alpha/beta."""
    return F.softplus(10.0 * x) / 10.0


def processed_sdf_grid(params: dict, cfg: ObjectConfig) -> torch.Tensor:
    """Optional smoothing + the learned mapping to the rendered SDF."""
    sdf = params["sdf_grid"]
    if cfg.smooth_ksize > 0:
        kernel = grid_ops.gaussian_kernel_1d(cfg.smooth_ksize, cfg.smooth_sigma, sdf.device)
        sdf = grid_ops.conv3d_separable_replicate(sdf, kernel)
    alpha = softplus10(params["sdf_alpha"])
    beta = softplus10(params["sdf_beta"])
    if cfg.beta_cap > 0:
        beta = torch.clamp(beta, max=cfg.beta_cap)
    return alpha * (torch.sigmoid(beta * sdf) - 0.5)


def _bounds(cfg: ObjectConfig, device):
    """The box as two [3] float32 tensors on `device`, made once per box and
    device by `graphsafe.const` (no synchronising copy, so a step that makes
    them first, under the sync check before a capture, does not raise)."""
    return (const(tuple(cfg.xyz_min), torch.float32, device),
            const(tuple(cfg.xyz_max), torch.float32, device))


def sdf_with_deform(params: dict, cfg: ObjectConfig, sdf_grid: torch.Tensor, pts: torch.Tensor,
                    use_deform: bool):
    """SDF value at world points, optionally through the deformation field.
    Returns (sdf [...], aux dict with deform/correction when use_deform)."""
    lo, hi = _bounds(cfg, pts.device)
    if use_deform:
        deform, correction = deform_mod.apply_deform(params["warpnet"], pts)
        sdf = grid_ops.trilinear_sample(sdf_grid, pts + deform, lo, hi)[..., 0]
        return sdf + correction[..., 0], {"deform": deform, "correction": correction}
    return grid_ops.trilinear_sample(sdf_grid, pts, lo, hi)[..., 0], {}


def _color_head(params: dict, cfg: ObjectConfig, pts, viewdirs, gradient, progress, lo, hi, k0=None):
    """Per-sample color: k0 features + BARF-masked position/view PE + normal ->
    MLP -> sigmoid. `k0` may be pre-sampled by the caller."""
    rays_xyz = (pts - lo) / (hi - lo)
    xyz_emb = pe.posenc_object(rays_xyz, cfg.posbase_pe, progress, cfg.barf_c2f)
    view_emb = pe.posenc_object(viewdirs, cfg.viewbase_pe, progress, cfg.barf_c2f)
    view_emb = view_emb[:, None, :].expand(pts.shape[:2] + (view_emb.shape[-1],))
    if k0 is None:
        k0 = sample_k0(params, cfg, pts, lo, hi)
    feats = [k0, xyz_emb, view_emb]
    if cfg.geo_rgb_dim == 3:
        feats.append(gradient / (safe_norm(gradient, keepdim=True) + 1e-5))
    return apply_mlp(params["rgbnet"], torch.cat(feats, dim=-1), final_activation=torch.sigmoid)


def _sample(cfg: ObjectConfig, rays_o, rays_d, lo, hi, near, far, jitter, mask_grid, mask_k):
    samp = ray_sampling.sample_ray(rays_o, rays_d, lo, hi, near=near, far=far,
                                   stepsize=cfg.stepsize, voxel_size=cfg.voxel_size,
                                   n_samples=cfg.n_samples, jitter=jitter)
    pts, step, mask = samp.pts, samp.step, samp.mask_inbbox
    if mask_grid is not None:
        # free-space skipping: keep the first K in-mask samples of each ray;
        # mask_k overrides the config budget (the trainer passes the tight
        # per-ray chord bound during the plastic phase)
        occ = maskcache.mask_lookup(mask_grid, pts, lo, hi)
        comp = maskcache.compact_ray_samples(pts, step, mask & occ, mask_k or cfg.maskcache_K)
        pts, step, mask = comp.pts, comp.step, comp.mask
    return samp, pts, step, mask


def render(params: dict, cfg: ObjectConfig, rays_o: torch.Tensor, rays_d: torch.Tensor,
           viewdirs: torch.Tensor, global_step, jitter: torch.Tensor | None = None,
           use_deform: bool = True, is_train: bool = True, near: float = 0.3, far: float = 4.0,
           bg: float = 0.0, mask_grid: torch.Tensor | None = None,
           mask_k: int | None = None) -> dict[str, Any]:
    """Train/eval volume render. rays_o/rays_d: [N, 3]; viewdirs unit [N, 3];
    `global_step`: a number or a 0-dim tensor (the schedules are tensor math);
    `jitter` [N, 1]: the training-time per-ray sample offset (None: none).

    Returns per-ray composited quantities plus the per-sample diagnostics the
    losses need (dense [N, S] with `mask` for validity).
    """
    lo, hi = _bounds(cfg, rays_o.device)
    progress = (torch.clamp(torch.as_tensor(global_step, dtype=torch.float32) / cfg.N_iters, 0.0, 1.0)
                if is_train else 1.0)
    samp, pts, step, mask = _sample(cfg, rays_o, rays_d, lo, hi, near, far,
                                    jitter if is_train else None, mask_grid, mask_k)
    sdf_grid = processed_sdf_grid(params, cfg)

    # With a dense k0, the sdf and the 12-channel k0 features are both sampled
    # at `pts`: they share one 13-channel gather (forward) and one 13-channel
    # row scatter (backward). With TensoRF the sdf takes the 1-channel lookups
    # and the colour head samples k0. The spatial gradient is analytic, so the
    # loss backward stays a first-order VJP.
    merged = cfg.grid_type == "dense"
    k0_feat = None
    aux = {}
    if use_deform:
        deform, correction, jac_warp, grad_corr = deform_mod.deform_with_jacobian_fwd(
            params["warpnet"], pts)
        sdf_val, tri_grad = grid_ops.trilinear_sample_with_grad(sdf_grid, pts + deform, lo, hi)
        sdf_final = sdf_val[..., 0] + correction[..., 0]
        # d sdf/d pts_j = sum_i J_warp[..., j, i] * d trilerp/d x_i + d corr/d pts_j
        gradient = torch.einsum("...ji,...i->...j", jac_warp, tri_grad[..., 0, :]) + grad_corr
        if merged:
            both = grid_ops.trilinear_sample(torch.cat([sdf_grid, params["k0_grid"]], dim=0), pts, lo, hi)
            sdf_wo_deform, k0_feat = both[..., 0], both[..., 1:]
        else:
            sdf_wo_deform = grid_ops.trilinear_sample(sdf_grid, pts, lo, hi)[..., 0]
        aux = {"sdf_deform": sdf_final - sdf_wo_deform, "grad_deform": jac_warp,
               "sdf_correct": correction}
    elif merged:
        both, tri_grad = grid_ops.trilinear_sample_with_grad(
            torch.cat([sdf_grid, params["k0_grid"]], dim=0), pts, lo, hi)
        sdf_final, k0_feat = both[..., 0], both[..., 1:]
        gradient = tri_grad[..., 0, :]
    else:
        sdf_val, tri_grad = grid_ops.trilinear_sample_with_grad(sdf_grid, pts, lo, hi)
        sdf_final = sdf_val[..., 0]
        gradient = tri_grad[..., 0, :]

    dist = cfg.stepsize * cfg.voxel_size
    if is_train and not cfg.s_learn:
        s_val = compositing.s_val_schedule(global_step, cfg.s_ratio, cfg.s_start, cfg.step_start)
    else:
        s_val = params["s_val"]

    alpha = compositing.neus_alpha_from_sdf(viewdirs[:, None, :], dist, sdf_final, gradient, s_val)
    alpha = torch.where(mask, alpha, 0.0)
    if cfg.use_pallas_composite and cfg.fast_color_thres <= 0:
        # fused path: alpha, transmittance, weights and the (rgb, step) sums in
        # one kernel; it reads the colours, so the colour head runs first
        true_cos = torch.sum(viewdirs[:, None, :] * gradient, dim=-1)
        cos_term = -torch.clamp(-true_cos, min=0.0)
        rgb = _color_head(params, cfg, pts, viewdirs, gradient, progress, lo, hi, k0=k0_feat)
        weights, alphainv_last, rgb_sum, n_step = fused_composite.fused_alpha_composite(
            sdf_final, cos_term, mask, rgb, step, 1.0 / s_val, dist)
        w = weights[..., None]
    else:
        weights, alphainv_last = compositing.alpha2weights(alpha)
        if cfg.fast_color_thres > 0:
            alpha = torch.where(weights > cfg.fast_color_thres, alpha, 0.0)
            weights, alphainv_last = compositing.alpha2weights(alpha)
        rgb = _color_head(params, cfg, pts, viewdirs, gradient, progress, lo, hi, k0=k0_feat)
        w = weights[..., None]
        rgb_sum = (w * rgb).sum(dim=1)
        n_step = (weights * step).sum(dim=1)

    cum_weights = w.sum(dim=1)                                   # [N, 1]
    rgb_marched = torch.clamp(rgb_sum + (1.0 - cum_weights) * bg, 0.0, 1.0)
    normal_marched = (w * (gradient / (safe_norm(gradient, keepdim=True) + 1e-6))).sum(dim=1)
    d_norm = torch.clamp(torch.linalg.norm(rays_d, dim=-1), min=1e-12)
    depth = samp.t_min / d_norm + n_step
    return {
        "rgb_marched": rgb_marched,
        "normal_marched": normal_marched,
        "cum_weights": cum_weights,
        "alphainv_cum": alphainv_last,
        "weights": weights,
        "raw_alpha": alpha,
        "depth": depth,
        "disp": 1.0 / torch.clamp(depth, min=1e-8),
        "mask": mask,
        "gradient": gradient,
        "s_val": torch.as_tensor(s_val, dtype=torch.float32, device=rays_o.device),
        "n_step": n_step,
        **aux,
    }


def query_surface_points(params: dict, cfg: ObjectConfig, rays_o: torch.Tensor,
                         rays_d: torch.Tensor, use_deform: bool = False, is_train: bool = False,
                         jitter: torch.Tensor | None = None, near: float = 0.3, far: float = 4.0):
    """First SDF zero crossing along each ray: out-of-box samples carry sdf = 1,
    the first sign change is the argmax of the sign-change indicator, and the
    crossing is interpolated linearly, z* = (s1*z2 - s2*z1)/(s1 - s2).

    Returns (points [N, 3], valid [N] bool, sdf_d [N, S]).
    """
    lo, hi = _bounds(cfg, rays_o.device)
    samp = ray_sampling.sample_ray(rays_o, rays_d, lo, hi, near=near, far=far,
                                   stepsize=cfg.stepsize, voxel_size=cfg.voxel_size,
                                   n_samples=cfg.n_samples, jitter=jitter if is_train else None)
    sdf_grid = processed_sdf_grid(params, cfg)
    sdf, _ = sdf_with_deform(params, cfg, sdf_grid, samp.pts, use_deform)
    sdf_d = torch.where(samp.mask_inbbox, sdf, 1.0)

    sign_change = (sdf_d[:, :-1] * sdf_d[:, 1:]) <= 0
    prev_idx = torch.argmax(sign_change.to(torch.int32), dim=1)    # first True (0 if none)
    next_idx = prev_idx + 1
    sdf1 = torch.gather(sdf_d, 1, prev_idx[:, None])[:, 0]
    sdf2 = torch.gather(sdf_d, 1, next_idx[:, None])[:, 0]
    dist = cfg.stepsize * cfg.voxel_size
    z1 = prev_idx.to(torch.float32) * dist + dist * 0.5
    z2 = next_idx.to(torch.float32) * dist + dist * 0.5
    # sign-preserving guard: a shallow crossing must not blow up the backward
    denom = sdf1 - sdf2
    denom = torch.sign(denom) * torch.clamp(denom.abs(), min=1e-6) + torch.where(denom == 0, 1e-6, 0.0)
    z_star = (sdf1 * z2 - sdf2 * z1) / denom
    z_star = torch.where((z_star < z1) | (z_star > z2), 0.0, z_star)
    valid = (z_star > 1e-10) & ((sdf1 * sdf2) < 0)

    d_norm = torch.clamp(torch.linalg.norm(rays_d, dim=-1), min=1e-12)
    interpx = samp.t_min + z_star / d_norm
    return rays_o + rays_d * interpx[:, None], valid, sdf_d


def query_surface_points_render(params: dict, cfg: ObjectConfig, rays_o: torch.Tensor,
                                rays_d: torch.Tensor, global_step, use_deform: bool = True,
                                jitter: torch.Tensor | None = None, near: float = 0.3,
                                far: float = 4.0, mask_grid: torch.Tensor | None = None,
                                mask_k: int | None = None):
    """Differentiable surface localisation by volume-rendered expected depth:
    depth = t_min + sum(w * step)/|d|; valid where any weight mass exists.
    Returns (points [N, 3], valid [N] bool, depth [N])."""
    lo, hi = _bounds(cfg, rays_o.device)
    samp, pts, step, mask = _sample(cfg, rays_o, rays_d, lo, hi, near, far, jitter, mask_grid, mask_k)
    sdf_grid = processed_sdf_grid(params, cfg)
    if use_deform:
        deform, correction, jac_warp, grad_corr = deform_mod.deform_with_jacobian_fwd(
            params["warpnet"], pts)
        sdf_val, tri_grad = grid_ops.trilinear_sample_with_grad(sdf_grid, pts + deform, lo, hi)
        sdf = sdf_val[..., 0] + correction[..., 0]
        gradient = torch.einsum("...ji,...i->...j", jac_warp, tri_grad[..., 0, :]) + grad_corr
    else:
        sdf_val, tri_grad = grid_ops.trilinear_sample_with_grad(sdf_grid, pts, lo, hi)
        sdf = sdf_val[..., 0]
        gradient = tri_grad[..., 0, :]
    dist = cfg.stepsize * cfg.voxel_size
    s_val = (compositing.s_val_schedule(global_step, cfg.s_ratio, cfg.s_start, cfg.step_start)
             if not cfg.s_learn else params["s_val"])
    d_norm = torch.clamp(torch.linalg.norm(rays_d, dim=-1), min=1e-12)
    viewdirs = rays_d / d_norm[:, None]
    alpha = compositing.neus_alpha_from_sdf(viewdirs[:, None, :], dist, sdf, gradient, s_val)
    alpha = torch.where(mask, alpha, 0.0)
    weights, _ = compositing.alpha2weights(alpha)
    n_step = (weights * step).sum(dim=1)
    depth = samp.t_min + n_step / d_norm
    return rays_o + rays_d * depth[:, None], n_step > 0.0, depth


def mesh_color_forward(params: dict, cfg: ObjectConfig, pts: np.ndarray, chunk: int = 65536) -> np.ndarray:
    """Vertex colours for mesh export, with the surface normal as the view
    direction: pts [V, 3] world vertices -> [V, 3] rgb in [0, 1]. The normal
    comes from the value+gradient lookup of the processed SDF grid at the
    deformed points; the chunks run on the params' device."""
    device = params["sdf_grid"].device
    lo, hi = _bounds(cfg, device)
    out = []
    with torch.no_grad():
        sdf_grid = processed_sdf_grid(params, cfg)
        for i in range(0, len(pts), chunk):
            p = torch.as_tensor(np.asarray(pts[i:i + chunk], np.float32), device=device)
            deform, _ = deform_mod.apply_deform(params["warpnet"], p)
            _, tri_grad = grid_ops.trilinear_sample_with_grad(sdf_grid, p + deform, lo, hi)
            gradient = tri_grad[:, 0, :]
            normal = gradient / (safe_norm(gradient, keepdim=True) + 1e-5)
            rgb = _color_head(params, cfg, p[:, None, :], -normal, gradient[:, None, :], 1.0, lo, hi)
            out.append(rgb[:, 0].cpu().numpy())
    return np.clip(np.concatenate(out), 0.0, 1.0)


def extract_sdf_volume(params: dict, cfg: ObjectConfig, resolution: int, use_deform: bool = True,
                       chunk: int = 65536) -> np.ndarray:
    """Dense (-SDF) volume [R, R, R] over the bounding box for marching cubes:
    the processed SDF at a regular grid of R^3 world points, through the
    deformation field, in chunks of `chunk` points on the params' device."""
    device = params["sdf_grid"].device
    lo, hi = cfg.xyz_min_np, cfg.xyz_max_np
    # float64 linspace cast to float32, as the reference builds its points
    axes = [torch.as_tensor(np.linspace(lo[a], hi[a], resolution).astype(np.float32), device=device)
            for a in range(3)]
    pts = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1).reshape(-1, 3)
    with torch.no_grad():
        sdf_grid = processed_sdf_grid(params, cfg)
        out = torch.cat([-sdf_with_deform(params, cfg, sdf_grid, pts[i:i + chunk], use_deform)[0]
                         for i in range(0, pts.shape[0], chunk)])
    return out.cpu().numpy().reshape(resolution, resolution, resolution)
