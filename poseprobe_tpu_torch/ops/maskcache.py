"""Free-space skipping: coarse occupancy mask + fixed-budget sample compaction.

Port of `poseprobe_tpu/ops/maskcache.py`. "Skip" is compaction to a fixed
budget: per ray, a stable argsort over the boolean keep-flags moves the
(order-preserving) in-mask samples to the front and the first ``K`` lanes are
gathered into dense ``[n_rays, K]`` tensors, so all per-sample work costs K
instead of S lanes. With ``K == S`` compaction equals masked-dense rendering.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.graphsafe import const


class CompactSamples(NamedTuple):
    pts: torch.Tensor    # [N, K, 3]
    step: torch.Tensor   # [N, K]
    mask: torch.Tensor   # [N, K] bool: valid AND in-mask
    index: torch.Tensor  # [N, K] original sample index


def _min_pool(sdf: torch.Tensor, dilate: int) -> torch.Tensor:
    """Min over a dilate^3 window with SAME padding, padded with +inf, the
    identity of the min, as the reference pads it. SAME puts the extra cell of
    an even window on the high side: low = (d-1)//2, high = d-1-low."""
    if dilate <= 1:
        return sdf
    low = (dilate - 1) // 2
    high = dilate - 1 - low
    padded = F.pad(sdf[None, None], (low, high) * 3, value=float("inf"))
    return -F.max_pool3d(-padded, dilate, 1)[0, 0]


def build_mask_grid(sdf_grid: torch.Tensor, thres: float, dilate: int = 3) -> torch.Tensor:
    """Boolean occupancy [X, Y, Z] from a raw SDF grid: ``min-pool(sdf) < thres``."""
    sdf = sdf_grid[0] if sdf_grid.ndim == 4 else sdf_grid
    return (_min_pool(sdf.detach(), dilate) < thres)


def build_mask_grid_mapped(mapped_grid: torch.Tensor, s_val: float, sigma: float = 3.0,
                           dilate: int = 3, min_frac: float = 0.02,
                           prev: torch.Tensor | None = None) -> torch.Tensor:
    """Occupancy from the MAPPED SDF at the current NeuS sharpness:
    ``min-pool(mapped_sdf) < sigma * s_val``. If the rebuilt mask would keep
    less than `min_frac` of the voxels, `prev` (or all-True) is returned."""
    sdf = mapped_grid[0] if mapped_grid.ndim == 4 else mapped_grid
    mask = _min_pool(sdf.detach(), dilate) < sigma * s_val
    if float(mask.float().mean()) < min_frac:
        return prev if prev is not None else torch.ones_like(mask)
    return mask


def max_inbbox_lanes(poses_w2c, Ks, H: int, W: int, xyz_min, xyz_max,
                     steplen: float, margin: int = 6) -> int:
    """Tight per-ray sample budget: the max in-bbox sample count over every
    pixel ray of the given views, plus a pose-drift margin (host numpy f64).

    With an all-True occupancy mask and ``K >= max_inbbox_lanes`` the
    compaction keeps every in-bbox sample of every ray: content-identical to
    the dense path, without the lanes the bbox-diagonal budget wastes."""
    lo = np.asarray(xyz_min, np.float64)
    hi = np.asarray(xyz_max, np.float64)
    poses_w2c = np.asarray(poses_w2c, np.float64)
    Ks = np.asarray(Ks, np.float64)
    u, v = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    pix = np.stack([u.ravel(), v.ravel(), np.ones(H * W)], -1)
    max_n = 0
    for w2c, K in zip(poses_w2c, Ks):
        R, t = w2c[:3, :3], w2c[:3, 3]
        o = -R.T @ t
        d = pix @ np.linalg.inv(K).T @ R
        with np.errstate(divide="ignore", invalid="ignore"):
            t0 = (lo - o) / d
            t1 = (hi - o) / d
        tmin = np.nanmax(np.minimum(t0, t1), axis=1)
        tmax = np.nanmin(np.maximum(t0, t1), axis=1)
        chord = np.clip(tmax - np.maximum(tmin, 0.0), 0.0, None)
        n_in = np.ceil(chord * np.linalg.norm(d, axis=1) / steplen)
        max_n = max(max_n, int(np.nanmax(n_in)))
    return max_n + margin


def mask_lookup(mask: torch.Tensor, xyz: torch.Tensor, xyz_min, xyz_max) -> torch.Tensor:
    """Nearest-voxel occupancy at world points [..., 3] (round half to even);
    out-of-bounds points read the clamped border voxel."""
    shape = mask.shape
    size = const(tuple(shape), torch.float32, xyz.device)
    scale = (size - 1.0) / (xyz_max - xyz_min)
    ijk = torch.round((xyz - xyz_min) * scale).to(torch.int64)
    i = ijk[..., 0].clamp(0, shape[0] - 1)
    j = ijk[..., 1].clamp(0, shape[1] - 1)
    k = ijk[..., 2].clamp(0, shape[2] - 1)
    return mask[i, j, k]


def compact_ray_samples(pts: torch.Tensor, step: torch.Tensor, keep: torch.Tensor,
                        K: int) -> CompactSamples:
    """Gather the first K in-mask samples of each ray into dense [N, K] tensors.

    keep: [N, S] bool. A stable argsort over ``~keep`` is an order-preserving
    partition (False sorts first), so the kept lanes stay depth-sorted."""
    order = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)[:, :K]
    return CompactSamples(
        pts=torch.gather(pts, 1, order[..., None].expand(-1, -1, 3)),
        step=torch.gather(step, 1, order),
        mask=torch.gather(keep, 1, order),
        index=order,
    )
