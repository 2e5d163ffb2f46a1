"""Ray sampling: the object branch's dense stepping through its box, and the
scene branch's depth sampling.

Port of `poseprobe_tpu/ops/ray_sampling.py`. Randomness is injected: the
object sampler's per-ray jitter, the scene sampler's stratified jitter and the
fine-sampling grid are tensors the caller draws, so a test can feed the JAX
function and this one the same numbers.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class RaySamples(NamedTuple):
    pts: torch.Tensor          # [N_rays, N_samples, 3] world-space sample points
    mask_inbbox: torch.Tensor  # [N_rays, N_samples] bool, True = inside the box
    step: torch.Tensor         # [N_rays, N_samples] distance along the ray from t_min (world units)
    t_min: torch.Tensor        # [N_rays]
    t_max: torch.Tensor        # [N_rays]


def n_samples_for_grid(world_size, stepsize: float) -> int:
    """Max sample count covering the grid diagonal."""
    ws = np.asarray(world_size, dtype=np.float64)
    return int(np.linalg.norm(ws + 1) / stepsize) + 1


def ray_aabb(rays_o, rays_d, xyz_min, xyz_max, near: float, far: float):
    """Slab-method ray/box entry and exit distances, clamped to [near, far], in
    units of the unnormalised direction. Returns (t_min, t_max, miss)."""
    vec = torch.where(rays_d == 0, torch.full_like(rays_d, 1e-6), rays_d)
    rate_a = (xyz_max - rays_o) / vec
    rate_b = (xyz_min - rays_o) / vec
    t_min = torch.clamp(torch.minimum(rate_a, rate_b).amax(-1), near, far)
    t_max = torch.clamp(torch.maximum(rate_a, rate_b).amin(-1), near, far)
    return t_min, t_max, t_max <= t_min


def sample_ray(rays_o, rays_d, xyz_min, xyz_max, near: float, far: float, stepsize: float,
               voxel_size: float, n_samples: int, jitter: torch.Tensor | None = None) -> RaySamples:
    """`n_samples` points per ray from the box entry point on; rays_d need not
    be unit (steps are world-metric via step / |rays_d|). `jitter` [N, 1] in
    [0, 1) is the training-time per-ray offset, None for none."""
    t_min, t_max, miss = ray_aabb(rays_o, rays_d, xyz_min, xyz_max, near, far)
    n_rays = rays_o.shape[0]
    rng_steps = torch.arange(n_samples, dtype=rays_o.dtype, device=rays_o.device).expand(n_rays, n_samples)
    if jitter is not None:
        rng_steps = rng_steps + jitter
    step = stepsize * voxel_size * rng_steps
    d_norm = torch.clamp(torch.linalg.norm(rays_d, dim=-1, keepdim=True), min=1e-12)
    interpx = t_min[..., None] + step / d_norm
    pts = rays_o[..., None, :] + rays_d[..., None, :] * interpx[..., None]
    inbbox = torch.all((pts >= xyz_min) & (pts <= xyz_max), dim=-1) & (~miss)[..., None]
    return RaySamples(pts=pts, mask_inbbox=inbbox, step=step, t_min=t_min, t_max=t_max)


def draw_render_noise(generator: torch.Generator, batch_size: int, num_rays: int,
                      n_samples: int, n_samples_fine: int, device) -> dict:
    """The draws of one training render: per-sample stratified jitter
    [B, R, S, 1] and the sorted fine-sampling grid [Sf + 1]."""
    jitter = torch.rand((batch_size, num_rays, n_samples, 1), generator=generator,
                        device=device)
    grid = torch.rand(n_samples_fine + 1, generator=generator, device=device)
    return {"jitter": jitter, "fine_grid": torch.sort(grid).values}


def sample_depth_stratified(jitter: torch.Tensor | None, batch_size: int, num_rays: int,
                            n_samples: int, depth_min, depth_max, param: str = "metric",
                            device="cuda") -> torch.Tensor:
    """[B, R, S, 1] depths; `jitter` [B, R, S, 1] in [0, 1), or None for bin centers."""
    if jitter is None:
        rand = torch.full((batch_size, num_rays, n_samples, 1), 0.5, device=device)
    else:
        rand = jitter
    rand = rand + torch.arange(n_samples, dtype=torch.float32, device=rand.device)[None, None, :, None]
    depth = rand / n_samples * (depth_max - depth_min) + depth_min
    if param == "inverse":
        depth = 1.0 / (depth + 1e-8)
    return depth


def merge_sorted_depths(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge of two per-ray ascending depth sets [..., Sa, 1], [..., Sb, 1].

    The merge of two sorted sets is the sorted union, so one sort along the
    samples axis gives the same values as the reference's rank merge.
    """
    return torch.sort(torch.cat([a, b], dim=-2), dim=-2).values


def sample_depth_to_max(batch_size: int, num_rays: int, n_samples: int,
                        depth_min, depth_max: torch.Tensor) -> torch.Tensor:
    """Depth samples up to a per-ray max [B, R] (visibility rendering), with
    the reference's rand=1 offset."""
    rand = 1.0 + torch.arange(n_samples, dtype=torch.float32, device=depth_max.device)
    rand = rand.expand(batch_size, num_rays, n_samples)[..., None]
    return rand / n_samples * (depth_max[..., None, None] - depth_min) + depth_min


def sample_depth_from_pdf(fine_grid: torch.Tensor | None, weights: torch.Tensor,
                          n_samples_coarse: int, n_samples_fine: int,
                          depth_min, depth_max) -> torch.Tensor:
    """Hierarchical inverse-CDF resampling. weights: [B, R, N]; returns
    [B, R, Nf, 1]. `fine_grid`: sorted uniforms [Nf + 1], or None for a
    linspace."""
    pdf = weights / (weights.sum(-1, keepdim=True) + 1e-6)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)   # [B, R, N+1]
    if fine_grid is None:
        fine_grid = torch.linspace(0.0, 1.0, n_samples_fine + 1, device=weights.device)
    unif = 0.5 * (fine_grid[:-1] + fine_grid[1:])
    unif = unif.expand(cdf.shape[:-1] + (n_samples_fine,)).contiguous()
    # idx = #(cdf <= u); cdf is per-ray non-decreasing, so the bin's CDF
    # endpoints are cdf[idx - 1] and cdf[min(idx, N)]
    idx = torch.searchsorted(cdf.contiguous(), unif, right=True)
    dd = (depth_max - depth_min) / n_samples_coarse
    idxf = idx.to(cdf.dtype)
    depth_low = depth_min + torch.clamp(idxf - 1.0, 0.0, n_samples_coarse) * dd
    depth_high = depth_min + torch.clamp(idxf, 0.0, n_samples_coarse) * dd
    n_edges = cdf.shape[-1]
    cdf_low = torch.gather(cdf, -1, (idx - 1).clamp(0, n_edges - 1))
    cdf_high = torch.gather(cdf, -1, idx.clamp(0, n_edges - 1))
    t = (unif - cdf_low) / (cdf_high - cdf_low + 1e-8)
    depth = depth_low + t * (depth_high - depth_low)
    return depth[..., None]
