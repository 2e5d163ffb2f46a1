"""Object-branch pose supervision: match reprojection and feature agreement
through SDF surface points.

Port of `poseprobe_tpu/losses/projection.py`: rays are cast through matched
pixels (`projection_error_loss`) or training pixels (`surface_feature_loss`),
the probe surface is found along them, and the disagreement in the paired
view -- pixel distance to the match, or feature-map dissimilarity -- is
penalised; this is how 2-D observations supervise the camera poses through
the SDF. Both are graph-safe: the view ids may be 0-dim device tensors, and
validity gates are masks, never indices.
"""
from __future__ import annotations

import torch

from ..core import geometry, pose as pose_ops, rays as rays_mod
from ..core.graphsafe import const, index
from ..models import object_sdf
from .common import compute_diff_loss

NL = 0.05  # near-plane clamp for projections


def _project_with_near_clamp(points_w, pose_w2c, K, inverse_y: bool, HW=None):
    """world2cam + near-z clamp + pinhole projection."""
    pc = pose_ops.world2cam(points_w, pose_w2c)
    invalid = (pc[..., 2:] < NL) if inverse_y else (-pc[..., 2:] < NL)
    pc = torch.where(invalid.expand(pc.shape), NL, pc)
    px = geometry.project_to_cam(pc, K)
    if not inverse_y and HW is not None:
        px = torch.cat([HW[1] - px[..., :1], px[..., 1:]], dim=-1)
    return px, invalid[..., 0]


def projection_error_loss(obj_params: dict, obj_cfg: object_sdf.ObjectConfig,
                          current_pose: torch.Tensor, Ks: torch.Tensor, coord_self: torch.Tensor,
                          coord_other: torch.Tensor, mconf: torch.Tensor, id_i, id_j,
                          global_step, inverse_y: bool, use_deform: bool,
                          pixel_thre: float | None = 200.0, near: float = 0.3, far: float = 4.0,
                          HW=None, mask_grid=None, mask_k=None):
    """current_pose [n_views, 3, 4], Ks [n_views, 3, 3], coord_self / coord_other
    [M, 2] pixels in views i / j, mconf [M] (0 = padding); the view ids are
    ints or 0-dim integer tensors.
    Returns (projection_dis_error, near_surface_loss); both directions
    (i -> j and j -> i) are stacked.
    """
    coords = torch.stack([coord_self, coord_other])             # [2, M, 2]
    src_idx = index((id_i, id_j), current_pose.device)
    dst_idx = src_idx.flip(0)
    conf2 = torch.stack([mconf, mconf])                          # [2, M]

    # index_select: its backward adds by index (an index_put's may wait for the host)
    c2w = pose_ops.invert(current_pose.index_select(0, src_idx))
    rays_o, rays_d = rays_mod.get_ray_dir(coords, Ks[src_idx], c2w, inverse_y=inverse_y,
                                          mode="no_center")
    flat_o, flat_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)

    if use_deform:
        pts, valid, _ = object_sdf.query_surface_points_render(
            obj_params, obj_cfg, flat_o, flat_d, global_step, use_deform=True, near=near, far=far,
            mask_grid=mask_grid, mask_k=mask_k)
    else:
        pts, valid, _ = object_sdf.query_surface_points(
            obj_params, obj_cfg, flat_o, flat_d, use_deform=False, near=near, far=far)

    # near-surface prior: matched rays should pass close to the probe box
    # "center" -- xyz_min + xyz_max without the /2, as the reference computes it
    center_pt = const(tuple((obj_cfg.xyz_min_np + obj_cfg.xyz_max_np).tolist()), torch.float32,
                      flat_o.device)
    dis2center = geometry.point_to_ray_distance(flat_o, flat_d, center_pt)
    near_surface = (torch.clamp(dis2center - obj_cfg.diagonal_length / 2.0, min=0.0)
                    * (conf2.reshape(-1) > 0)).sum()

    pts, valid = pts.reshape(2, -1, 3), valid.reshape(2, -1)
    px, invalid_z = _project_with_near_clamp(pts, current_pose.index_select(0, dst_idx), Ks[dst_idx],
                                           inverse_y, HW)
    target = torch.stack([coord_other, coord_self])
    diff = torch.linalg.norm(px - target, dim=-1)                # [2, M]
    valid_all = (~invalid_z) & valid & (conf2 > 0)
    if pixel_thre is not None:
        valid_all = valid_all & (diff.detach() <= pixel_thre)
    proj_err = compute_diff_loss("huber", diff, weights=conf2, mask=valid_all, delta=1.0)
    return proj_err, near_surface


def surface_feature_loss(obj_params: dict, obj_cfg: object_sdf.ObjectConfig,
                         current_pose: torch.Tensor, Ks: torch.Tensor, rays_o: torch.Tensor,
                         rays_d: torch.Tensor, id_i, id_j, feature_maps: torch.Tensor, global_step,
                         inverse_y: bool, use_deform: bool, near: float = 0.3, far: float = 4.0):
    """Cosine feature agreement of SDF-surface points projected into both views.

    rays_o / rays_d [M, 3] are rays of view i; feature_maps [n_views, H', W', C]
    on the pixel grid. A cycle check gates validity: the point, projected into
    view j and found again along view j's ray, must land within two voxels of
    itself. Returns 1 - the masked mean cosine and the number of valid rays
    (a 0-dim float tensor, left on the device).
    """
    ids = index((id_i, id_j), current_pose.device)
    pose_ij = current_pose.index_select(0, ids)
    K_ij = Ks.index_select(0, ids)
    pts, valid, _ = object_sdf.query_surface_points_render(
        obj_params, obj_cfg, rays_o, rays_d, global_step, use_deform=use_deform, near=near, far=far)

    # project into view j, re-cast rays there, and re-query the surface
    px_j, invalid_j = _project_with_near_clamp(pts[None], pose_ij[1:], K_ij[1:], inverse_y)
    c2w_j = pose_ops.invert(pose_ij[1:])
    ro_j, rd_j = rays_mod.get_ray_dir(px_j, K_ij[1:], c2w_j, inverse_y=inverse_y, mode="no_center")
    pts_ref, valid_ref, _ = object_sdf.query_surface_points_render(
        obj_params, obj_cfg, ro_j.reshape(-1, 3), rd_j.reshape(-1, 3), global_step,
        use_deform=use_deform, near=near, far=far)
    cycle_ok = torch.linalg.norm(pts - pts_ref, dim=-1) < obj_cfg.voxel_size * 2

    px_i, invalid_i = _project_with_near_clamp(pts[None], pose_ij[:1], K_ij[:1], inverse_y)
    valid_all = (valid & valid_ref & cycle_ok & ~invalid_i[0] & ~invalid_j[0]).to(torch.float32)

    maps = feature_maps.index_select(0, ids)
    f_i = geometry.bilinear_image_sample(maps[0], px_i[0])
    f_j = geometry.bilinear_image_sample(maps[1], px_j[0])
    cos = (f_i * f_j).sum(-1) / (torch.linalg.norm(f_i, dim=-1) * torch.linalg.norm(f_j, dim=-1) + 1e-8)
    # masked mean cosine similarity -> loss (1 - mean_cos)
    n_valid = valid_all.sum()
    loss = 1.0 - (cos * valid_all).sum() / (n_valid + 1e-6)
    return loss, n_valid
