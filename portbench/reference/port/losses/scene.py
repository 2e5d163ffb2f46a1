"""Scene-branch losses: photometric + regularizers, correspondence, depth consistency.

Port of `poseprobe_tpu/losses/scene.py` (the functions the training step
calls). Filters are multiplicative weight masks over fixed-size pixel sets.
"""
from __future__ import annotations

from typing import Any

import torch

from ..core import geometry, pose as pose_ops, rays as rays_mod
from ..core.graphsafe import const, take
from ..models import scene_nerf
from .common import compute_diff_loss, huber


def huber_loss_x2(pred: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """huber(delta=0.5) * 2."""
    return huber(pred - label, delta=0.5).mean() * 2.0


def depth_patch_loss(depths: torch.Tensor, patch_size: int, pad: float = 0.001) -> torch.Tensor:
    """Charbonnier smoothness over depth patches."""
    d = depths.reshape(depths.shape[0], -1, patch_size ** 2)
    resid_sq = (d[..., None] - d[..., None, :]) ** 2
    return torch.sqrt(resid_sq + pad ** 2).mean()


def distortion_loss(t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """mipnerf360 distortion. t, w: [B, R, N, 1]."""
    w, t = w[..., 0], t[..., 0]
    ut = (t[..., 1:] + t[..., :-1]) / 2
    wm = w[..., 1:]
    dut = (ut[..., :, None] - ut[..., None, :]).abs()
    loss_inter = (wm * (wm[..., None, :] * dut).sum(-1)).sum(-1)
    loss_intra = (w[..., 1:] ** 2 * torch.diff(t, dim=-1)).sum(-1) / 3
    return (loss_inter + loss_intra).mean()


def photometric_and_regu_loss(render_out: dict[str, Any], target_rgb: torch.Tensor, opt: Any,
                              fg_mask: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
    lw = dict(opt.loss_weight) if isinstance(opt.loss_weight, tuple) else opt.loss_weight
    loss = {}
    if opt.huber_photometric:
        loss["render"] = huber_loss_x2(render_out["rgb"], target_rgb)
        if "rgb_fine" in render_out:
            loss["render"] = loss["render"] + huber_loss_x2(render_out["rgb_fine"], target_rgb)
    else:
        loss["render"] = ((render_out["rgb"] - target_rgb) ** 2).mean()
        if "rgb_fine" in render_out:
            loss["render"] = loss["render"] + ((render_out["rgb_fine"] - target_rgb) ** 2).mean()
    if fg_mask is not None and lw.get("fg_mask") is not None:
        m = 0.5 * (fg_mask - render_out["opacity"]).abs().mean()
        if "opacity_fine" in render_out:
            m = m + 0.5 * (fg_mask - render_out["opacity_fine"]).abs().mean()
        loss["fg_mask"] = m
    if lw.get("distortion") is not None:
        s = 1e-3 * 2
        d = s * distortion_loss(render_out["t"], render_out["weights"])
        if "weights_fine" in render_out:
            d = d + s * distortion_loss(render_out["t_fine"], render_out["weights_fine"])
        loss["distortion"] = d
    if lw.get("depth_patch") is not None:
        s = 0.01 * 2
        dp = s * depth_patch_loss(render_out["depth"], opt.depth_regu_patch_size)
        if "depth_fine" in render_out:
            dp = dp + s * depth_patch_loss(render_out["depth_fine"], opt.depth_regu_patch_size)
        loss["depth_patch"] = dp
    return loss


def _repro_loss_one_direction(pixels_self, depth_self, intr_self, pixels_other, intr_other,
                              T_self2other, conf, valid, diff_loss_type="huber"):
    pts_repr, _ = geometry.batch_project_to_other_img(
        pixels_self, di=depth_self, Ki=intr_self, Kj=intr_other, T_itoj=T_self2other,
        return_depth=True)
    return compute_diff_loss(diff_loss_type, pts_repr - pixels_other, weights=conf, mask=valid,
                             dim=-1)


def correspondence_pair_rays(poses_w2c, intr, pixels_self, pixels_other, id_self, id_other):
    """Ray origins/directions for both pixel sets of a match pair: [2, M, 3].
    The view ids are ints or 0-dim integer tensors."""
    pose_stack = torch.stack([take(poses_w2c, id_self), take(poses_w2c, id_other)])
    intr_stack = torch.stack([take(intr, id_self), take(intr, id_other)])
    pixels_stack = torch.stack([pixels_self, pixels_other])
    return rays_mod.get_center_and_ray_at_pixels(pose_stack, pixels_stack, intr_stack)


def correspondence_loss_from_depths(depth_pair, depth_fine_pair, poses_w2c, intr, pixels_self,
                                    pixels_other, conf, id_self, id_other, iteration,
                                    opt: Any) -> torch.Tensor:
    """Reprojection part of the correspondence loss, given the rendered depths
    [2, M] at both pixel sets (coarse, and fine or None). `iteration` is a
    number or a 0-dim tensor: the weight's halving is evaluated as tensor
    math, in float32 as the reference's traced step does."""
    intr_self, intr_other = take(intr, id_self), take(intr, id_other)
    T_s2o = (pose_ops.pad(take(poses_w2c, id_other))
             @ pose_ops.invert_4x4(pose_ops.pad(take(poses_w2c, id_self))))
    T_o2s = pose_ops.invert_4x4(T_s2o)
    valid = (conf > 0)[:, None]
    conf_w = conf[:, None]

    def both_dirs(d):
        l1 = _repro_loss_one_direction(pixels_self, d[0], intr_self, pixels_other, intr_other,
                                       T_s2o, conf_w, valid, opt.diff_loss_type)
        l2 = _repro_loss_one_direction(pixels_other, d[1], intr_other, pixels_self, intr_self,
                                       T_o2s, conf_w, valid, opt.diff_loss_type)
        return l1 + l2

    loss = both_dirs(depth_pair)
    if depth_fine_pair is not None:
        loss = (loss + both_dirs(depth_fine_pair)) / 4.0
    else:
        loss = loss / 2.0
    if opt.gradually_decrease_corres_weight:
        # halve every corres_weight_reduct_at_x_iter after the start
        start = opt.iter_start_decrease_corres_weight
        it = torch.as_tensor(iteration)
        gamma = 2.0 ** torch.floor(torch.clamp(it - start, min=0) / opt.corres_weight_reduct_at_x_iter)
        loss = loss / torch.where(it < start, 1.0, gamma)
    return loss


def interpolate_pose_toward(poses_c2w: torch.Tensor, id_self, w) -> torch.Tensor:
    """Linear 4x4 blend between a pose and its nearest (by camera center)
    other pose, returned as w2c."""
    centers = poses_c2w[:, :3, 3]
    d = torch.linalg.norm(centers - take(centers, id_self)[None], dim=-1)
    d = torch.where(torch.arange(d.shape[0], device=d.device) == id_self,
                    torch.full_like(d, float("inf")), d)
    id_other = torch.argmin(d)
    blend = w * take(poses_c2w, id_self) + (1 - w) * take(poses_c2w, id_other)
    return pose_ops.invert_4x4(blend)


def depth_consistency_from_ref_depth(scene_params: dict, scene_cfg: scene_nerf.SceneConfig,
                                     poses_w2c: torch.Tensor, intr: torch.Tensor,
                                     pixels_ref: torch.Tensor, depth_ref: torch.Tensor, id_self,
                                     interp_w, H: int, W: int, depth_range, progress, iteration,
                                     compute_fine: bool, opt: Any, noise: dict | None = None,
                                     ref_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Depth consistency given an already-rendered reference depth [P] at
    `pixels_ref` [P, 2]: project the pseudo-GT points into a pose blended
    toward the nearest view, keep the ones in the image, in front and
    visible (render-to-max transmittance >= 0.2), and compare the depth
    rendered there. Poses are detached; `noise` is the render's draws."""
    poses_w2c = poses_w2c.detach()
    poses_c2w = pose_ops.invert_4x4(pose_ops.pad(poses_w2c))
    intr_ref = take(intr, id_self)
    pts3d_w = geometry.batch_backproject_to_3d(pixels_ref, depth_ref, intr_ref, take(poses_c2w, id_self))
    pose_w2c_unseen = interpolate_pose_toward(poses_c2w, id_self, interp_w)
    pts_img, pseudo_depth = geometry.batch_project(pts3d_w, T_itoj=pose_w2c_unseen, Kj=intr_ref,
                                                   return_depth=True)
    valid_pts = ((pts_img[:, 0] >= 0) & (pts_img[:, 1] >= 0)
                 & (pts_img[:, 0] <= W - 1) & (pts_img[:, 1] <= H - 1)
                 & (pseudo_depth >= depth_range[0]))
    if ref_valid is not None:
        valid_pts = valid_pts & ref_valid
    hi = const((W - 1.0, H - 1.0), torch.float32, pts_img.device)
    pts_img_safe = torch.minimum(torch.clamp(pts_img, min=0.0), hi)

    center_u, ray_u = rays_mod.get_center_and_ray_at_pixels(pose_w2c_unseen[:3], pts_img_safe,
                                                            intr_ref)
    with torch.no_grad():
        vis_out = scene_nerf.render_rays_to_max(scene_params, scene_cfg, center_u, ray_u,
                                                depth_range[0], pseudo_depth[None], progress,
                                                compute_fine=compute_fine)
    vis_key = "all_cumulated_fine" if "all_cumulated_fine" in vis_out else "all_cumulated"
    visibility = vis_out[vis_key][0]
    weight_mask = (valid_pts & (visibility >= 0.2)).float()

    ret_u = scene_nerf.render_rays(scene_params, scene_cfg, center_u, ray_u, depth_range,
                                   progress, noise=noise, compute_fine=compute_fine)

    def one(depth_key, opacity_key):
        d = ret_u[depth_key][0, :, 0]
        acc = ret_u[opacity_key][0, :, 0].detach()
        return compute_diff_loss(opt.diff_loss_type, pseudo_depth - d, weights=visibility * acc,
                                 mask=weight_mask)

    loss = one("depth", "opacity")
    if "depth_fine" in ret_u:
        loss = loss + one("depth_fine", "opacity_fine")
    return loss


def depth_consistency_loss(scene_params: dict, scene_cfg: scene_nerf.SceneConfig,
                           poses_w2c: torch.Tensor, intr: torch.Tensor, pixels_ref: torch.Tensor,
                           id_self, interp_w, H: int, W: int, depth_range, progress, iteration,
                           compute_fine: bool, use_fine_depth_as_ref: bool, opt: Any,
                           noise_ref: dict | None = None, noise: dict | None = None) -> torch.Tensor:
    """Depth consistency with a fresh reference render: render depth at the
    pixels `pixels_ref` [P, 2] of view `id_self` (an int or a 0-dim device
    index) from its detached pose, then `depth_consistency_from_ref_depth`.
    `noise_ref` / `noise`: the draws of the reference render and of the
    render at the unseen pose."""
    pose_w2c_ref = take(pose_ops.pad(poses_w2c.detach()), id_self)
    center, ray = rays_mod.get_center_and_ray_at_pixels(pose_w2c_ref[:3], pixels_ref,
                                                        take(intr, id_self))
    ret_ref = scene_nerf.render_rays(scene_params, scene_cfg, center, ray, depth_range, progress,
                                     noise=noise_ref, compute_fine=compute_fine)
    depth_ref = (ret_ref["depth_fine"] if (use_fine_depth_as_ref and "depth_fine" in ret_ref)
                 else ret_ref["depth"])[0, :, 0]
    return depth_consistency_from_ref_depth(
        scene_params, scene_cfg, poses_w2c, intr, pixels_ref, depth_ref, id_self, interp_w, H, W,
        depth_range, progress, iteration, compute_fine, opt, noise=noise)
