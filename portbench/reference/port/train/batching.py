"""Ray/pixel batch sampling: the object branch's semantic sampler and the
scene branch's patches shared across views.

Port of `poseprobe_tpu/train/batching.py`. The random draws are tensors
(`draw_object_batch`, `draw_scene_pixels`), so a test can hand the JAX
samplers' numbers to these.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import pose as pose_ops

SEMANTIC_FRACS = (0.2, 0.3, 0.5)  # background / boundary / object


class ObjectBatch(NamedTuple):
    rays_o: torch.Tensor    # [N, 3]
    rays_d: torch.Tensor    # [N, 3] (unnormalized)
    viewdirs: torch.Tensor  # [N, 3]
    target: torch.Tensor    # [N, 3]
    mask: torch.Tensor      # [N, 1]
    view_idx: torch.Tensor  # [N]


def rays_from_pixels_object(pixels, view_idx, Ks, current_pose, inverse_y: bool):
    """Object-branch rays at (x, y) pixel coords (+0.5 centers) per view index."""
    K = Ks[view_idx]                                       # [N, 3, 3]
    c2w = pose_ops.invert(current_pose).index_select(0, view_idx)   # [N, 3, 4]
    x = pixels[:, 0].to(torch.float32) + 0.5
    y = pixels[:, 1].to(torch.float32) + 0.5
    dx, dy = (x - K[:, 0, 2]) / K[:, 0, 0], (y - K[:, 1, 2]) / K[:, 1, 1]
    if inverse_y:
        dirs = torch.stack([dx, dy, torch.ones_like(x)], -1)
    else:
        dirs = torch.stack([dx, -dy, -torch.ones_like(x)], -1)
    rays_d = torch.einsum("nc,nrc->nr", dirs, c2w[:, :3, :3])
    rays_o = c2w[:, :3, 3]
    viewdirs = rays_d / torch.clamp(torch.linalg.norm(rays_d, dim=-1, keepdim=True), min=1e-12)
    return rays_o, rays_d, viewdirs


def draw_object_batch(generator: torch.Generator, n_rand: int, n_active: int, device="cuda") -> dict:
    """The draws of `sample_object_batch`: a view and a semantic class per ray,
    and the uniform that picks the pixel from that pool. The class is the
    inverse CDF of SEMANTIC_FRACS at a uniform (`torch.multinomial` waits for
    the host on a card)."""
    view = torch.randint(0, n_active, (n_rand,), generator=generator, device=device)
    u = torch.rand(n_rand, generator=generator, device=device)
    cls = sum((u >= edge).long() for edge in np.cumsum(SEMANTIC_FRACS[:-1]).tolist())
    return {"view": view, "cls": cls, "pick": torch.rand(n_rand, generator=generator, device=device)}


def sample_object_batch(draws: dict, images: torch.Tensor, masks: torch.Tensor, Ks: torch.Tensor,
                        current_pose: torch.Tensor, sampler_pixels: torch.Tensor,
                        sampler_counts: torch.Tensor, inverse_y: bool) -> ObjectBatch:
    """images [n_train, H, W, 3], masks [n_train, H, W, 1], sampler_pixels
    [n_train, 3, max_pix, 2] (x, y), sampler_counts [n_train, 3]."""
    view, cls = draws["view"], draws["cls"]
    count = sampler_counts[view, cls]
    pick = (draws["pick"] * count).to(torch.int64)
    pixels = sampler_pixels[view, cls, pick]               # [N, 2] (x, y)
    rays_o, rays_d, viewdirs = rays_from_pixels_object(pixels, view, Ks, current_pose, inverse_y)
    target = images[view, pixels[:, 1], pixels[:, 0]]
    mask = masks[view, pixels[:, 1], pixels[:, 0]]
    return ObjectBatch(rays_o, rays_d, viewdirs, target, mask, view)


class SceneBatch(NamedTuple):
    pixels: torch.Tensor   # [B, P, 2] float pixel coords (per view)
    target: torch.Tensor   # [B, P, 3] per-view rgb at those pixels
    active: torch.Tensor   # [B] 1.0 where the view participates in the loss


def dilate_fg_mask_pools(masks: np.ndarray, patch_size: int, dilation: int = 10):
    """Per-view pixel pools inside the 10x(3x3)-dilated foreground mask,
    excluding the last ``patch_size + 1`` rows/cols; (x, y) lists padded to a
    common length. Returns (pools [B, max_n, 2] int32, counts [B] int32)."""
    m = np.asarray(masks)
    if m.ndim == 4:
        m = m[..., 0]
    m = m > 0.5
    B, H, W = m.shape
    d = m.copy()
    for _ in range(dilation):
        grown = d.copy()
        grown[:, 1:, :] |= d[:, :-1, :]
        grown[:, :-1, :] |= d[:, 1:, :]
        grown[:, :, 1:] |= d[:, :, :-1]
        grown[:, :, :-1] |= d[:, :, 1:]
        grown[:, 1:, 1:] |= d[:, :-1, :-1]
        grown[:, 1:, :-1] |= d[:, :-1, 1:]
        grown[:, :-1, 1:] |= d[:, 1:, :-1]
        grown[:, :-1, :-1] |= d[:, 1:, 1:]
        d = grown
    d[:, H - patch_size - 1:, :] = False
    d[:, :, W - patch_size - 1:] = False
    pools, counts = [], []
    for b in range(B):
        ys, xs = np.where(d[b])
        pools.append(np.stack([xs, ys], -1).astype(np.int32))
        counts.append(len(xs))
    max_n = max(max(counts), 1)
    padded = np.zeros((B, max_n, 2), np.int32)
    for b in range(B):
        if counts[b] > 0:
            padded[b, :counts[b]] = pools[b]
    return padded, np.asarray(counts, np.int32)


def _expand_patches(px: torch.Tensor, py: torch.Tensor, patch_size: int):
    """[..., n] patch corners -> [..., n*patch_size**2] pixel coords."""
    d = torch.arange(patch_size, device=px.device)
    DY, DX = torch.meshgrid(d, d, indexing="ij")
    xs = (px[..., None] + DX.reshape(-1)).reshape(*px.shape[:-1], -1)
    ys = (py[..., None] + DY.reshape(-1)).reshape(*py.shape[:-1], -1)
    return xs, ys


def _patch_counts(rays_per_view: int, patch_size: int, center_fraction: float,
                  has_fg: bool, n_fg_patches: int):
    n_patches = max(rays_per_view // (patch_size ** 2), 1)
    n_fg = min(int(n_fg_patches), n_patches) if has_fg else 0
    n_center = int(n_patches * center_fraction) if (center_fraction > 0 and n_fg == 0) else 0
    return n_patches - n_fg - n_center, n_center, n_fg


def _box(H: int, W: int, patch_size: int, precrop_frac: float):
    """Corner offset and exclusive upper bound of the center pre-crop box."""
    dH, dW = int(H // 2 * precrop_frac), int(W // 2 * precrop_frac)
    return (H // 2 - dH, W // 2 - dW,
            max(2 * dH - patch_size, 1), max(2 * dW - patch_size, 1))


def draw_scene_pixels(generator: torch.Generator, n_views: int, rays_per_view: int, H: int,
                      W: int, patch_size: int, precrop: bool = False, precrop_frac: float = 0.5,
                      center_fraction: float = 0.0, has_fg: bool = False,
                      n_fg_patches: int = 0, device="cuda") -> dict:
    """The draws of `sample_scene_pixels`: patch-corner integers x, y in
    [0, xmax) / [0, ymax) before the box offset, the center-box corners cx, cy,
    and the fg-pool uniforms fg_u [n_views, n_fg]."""
    n_rand, n_center, n_fg = _patch_counts(rays_per_view, patch_size, center_fraction, has_fg,
                                           n_fg_patches)
    if precrop:
        _, _, ymax, xmax = _box(H, W, patch_size, precrop_frac)
    else:
        ymax, xmax = max(H - patch_size - 1, 1), max(W - patch_size - 1, 1)
    _, _, cymax, cxmax = _box(H, W, patch_size, precrop_frac)

    def randint(high, n):
        return torch.randint(0, high, (n,), generator=generator, device=device)

    return {"x": randint(xmax, n_rand), "y": randint(ymax, n_rand),
            "cx": randint(cxmax, n_center), "cy": randint(cymax, n_center),
            "fg_u": torch.rand((n_views, n_fg), generator=generator, device=device)}


def sample_scene_pixels(draws: dict, n_views: int, H: int, W: int, patch_size: int,
                        images: torch.Tensor, n_active: int, precrop: bool = False,
                        precrop_frac: float = 0.5, fg_pixels: torch.Tensor | None = None,
                        fg_counts: torch.Tensor | None = None) -> SceneBatch:
    """Pixel set (with patch expansion) rendered by every view: a random patch
    set shared across views (from the pre-crop box during warm-up), plus the
    center-box patches, or per-view patches from the dilated-foreground pools."""
    if precrop:
        y0, x0, _, _ = _box(H, W, patch_size, precrop_frac)
    else:
        y0, x0 = 0, 0
    cy0, cx0, _, _ = _box(H, W, patch_size, precrop_frac)
    px = torch.cat([x0 + draws["x"], cx0 + draws["cx"]])
    py = torch.cat([y0 + draws["y"], cy0 + draws["cy"]])
    px_b = px.expand(n_views, px.shape[0])
    py_b = py.expand(n_views, py.shape[0])
    if draws["fg_u"].shape[-1] > 0:
        counts = torch.clamp(fg_counts[:n_views], min=1)
        pick = (draws["fg_u"] * counts[:, None]).to(torch.int64)
        sel = torch.gather(fg_pixels[:n_views].long(), 1,
                           pick[..., None].expand(-1, -1, 2))          # [B, n_fg, 2]
        px_b = torch.cat([px_b, sel[..., 0]], dim=1)
        py_b = torch.cat([py_b, sel[..., 1]], dim=1)
    xs, ys = _expand_patches(px_b, py_b, patch_size)
    pixels = torch.stack([xs, ys], -1).float()
    vidx = torch.arange(n_views, device=images.device)[:, None]
    target = images[vidx, ys, xs]
    active = (torch.arange(n_views, device=images.device) < n_active).float()
    return SceneBatch(pixels=pixels, target=target, active=active)
