"""Visualization: object-branch full renders and validation panels.

Port of `render_object_image` and `validation_panel` of
`poseprobe_tpu/utils/vis.py`. Its matplotlib plots (`plot_save_poses`,
`save_match_plot`) are not ported: the machine with the card has no
matplotlib (`ROADMAP.md`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import pose as pose_ops, rays as rays_mod
from ..models import object_sdf


def render_object_image(obj_params, obj_cfg, pose_w2c, K, H: int, W: int, inverse_y: bool,
                        near: float, far: float, bg: float = 0.0, chunk: int = 4096) -> dict:
    """Full-image render of one view through the object branch, chunked, in
    eval mode, on the params' device: {'rgb' [H, W, 3], 'depth' [H, W],
    'normal' [H, W, 3], 'opacity' [H, W]}."""
    device = obj_params["sdf_grid"].device
    pose_w2c = torch.as_tensor(np.asarray(pose_w2c), dtype=torch.float32, device=device)
    K = torch.as_tensor(np.asarray(K), dtype=torch.float32, device=device)
    c2w = pose_ops.invert(pose_w2c[None])[0]
    ro, rd = rays_mod.get_rays(H, W, K, c2w, inverse_y=inverse_y)
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    outs = {"rgb": [], "depth": [], "normal": [], "opacity": []}
    with torch.no_grad():
        for c in range(0, H * W, chunk):
            out = object_sdf.render(obj_params, obj_cfg, ro[c:c + chunk], rd[c:c + chunk], vd[c:c + chunk],
                                    global_step=0.0, is_train=False, near=near, far=far, bg=bg)
            outs["rgb"].append(out["rgb_marched"])
            outs["depth"].append(out["depth"])
            outs["normal"].append(out["normal_marched"])
            outs["opacity"].append(out["cum_weights"][:, 0])
    return {"rgb": torch.cat(outs["rgb"]).reshape(H, W, 3), "depth": torch.cat(outs["depth"]).reshape(H, W),
            "normal": torch.cat(outs["normal"]).reshape(H, W, 3),
            "opacity": torch.cat(outs["opacity"]).reshape(H, W)}


def validation_panel(gt_rgb: np.ndarray, pred_rgb: np.ndarray, depth: np.ndarray,
                     opacity: np.ndarray | None = None) -> np.ndarray:
    """[H, n*W, 3] uint8 side-by-side panel (gt | pred | depth | opacity)."""
    from ..eval.video import colorize_depth

    tiles = [(np.clip(np.asarray(gt_rgb), 0, 1) * 255).astype(np.uint8),
             (np.clip(np.asarray(pred_rgb), 0, 1) * 255).astype(np.uint8),
             colorize_depth(np.asarray(depth))]
    if opacity is not None:
        op = np.clip(np.asarray(opacity), 0, 1)
        tiles.append((np.repeat(op[..., None], 3, -1) * 255).astype(np.uint8))
    return np.concatenate(tiles, axis=1)
