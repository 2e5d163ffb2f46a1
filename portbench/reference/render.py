"""The reference's full-image render: a frozen copy of the port's
`eval/evaluator.render_full` chunk loop over the reference's own
`render_rays` (plain PyTorch; the MLPs in the configuration's precision)."""
from __future__ import annotations

import torch

from .port.core import rays as rays_mod
from .port.models import scene_nerf


def render_full(scene_params: dict, scene_cfg, pose_w2c, K, H: int, W: int, depth_range,
                chunk: int = 4096, use_fine: bool | None = None, progress: float = 1.0) -> dict:
    """{'rgb', 'depth', 'depth_var', 'opacity'}, each [H, W, C]."""
    if use_fine is None:
        use_fine = scene_cfg.fine_sampling
    device = pose_w2c.device
    ys, xs = torch.meshgrid(torch.arange(H, device=device, dtype=torch.float32),
                            torch.arange(W, device=device, dtype=torch.float32), indexing="ij")
    pixels = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)
    suffix = "_fine" if use_fine else ""
    outs = {"rgb": [], "depth": [], "depth_var": [], "opacity": []}
    with torch.no_grad():
        center, ray = rays_mod.get_center_and_ray_at_pixels(pose_w2c[None], pixels, K[None])
        for c in range(0, H * W, chunk):
            rets = scene_nerf.render_rays(scene_params, scene_cfg, center[:, c:c + chunk], ray[:, c:c + chunk],
                                          depth_range, progress=progress, noise=None, compute_fine=use_fine)
            for k in outs:
                outs[k].append(rets[k + suffix])
    return {k: torch.cat(v, dim=1).reshape(H, W, -1) for k, v in outs.items()}
