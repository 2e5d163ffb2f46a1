"""Volume-rendering compositing: alpha -> weights and the NeRF composite.

Port of `poseprobe_tpu/ops/compositing.py` (`alpha2weights`,
`s_val_schedule`, `neus_alpha_from_sdf`, `nerf_composite`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

EARLY_TERMINATION_T = 1e-3  # transmittance below which a sample stops contributing


class _CumprodNonzero(torch.autograd.Function):
    """`torch.cumprod` along the last axis of a tensor without zeros, with the
    backward PyTorch takes for such a tensor (the reversed cumsum of
    grad * out, over the input), minus PyTorch's test for zeros, which reads
    a value back to the host and so cannot run in a captured step."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return torch.flip(torch.cumsum(torch.flip(grad * out, [-1]), -1), [-1]) / x


def alpha2weights(alpha: torch.Tensor, early_termination: bool = True):
    """Compositing weights from per-sample alphas [..., N].

    Returns (weights [..., N], alphainv_last [...]): the background
    transmittance after the last sample.
    """
    one_minus = torch.clamp(1.0 - alpha, 1e-10, 1.0)
    T = _CumprodNonzero.apply(torch.cat([torch.ones_like(one_minus[..., :1]), one_minus[..., :-1]],
                                        dim=-1))
    if early_termination:
        weights = torch.where(T > EARLY_TERMINATION_T, T * alpha, torch.zeros_like(alpha))
    else:
        weights = T * alpha
    return weights, (T * one_minus)[..., -1]


def s_val_schedule(global_step, s_ratio: float, s_start: float, step_start: int = 0):
    """NeuS sharpness schedule s = s_ratio / (step + s_ratio/s_start - step_start)."""
    return 1.0 / (global_step + s_ratio / s_start - step_start) * s_ratio


def neus_alpha_from_sdf(viewdirs: torch.Tensor, dist, sdf: torch.Tensor,
                        gradients: torch.Tensor, s_val) -> torch.Tensor:
    """NeuS-style alpha from SDF values and gradients at samples.

    viewdirs: [..., 3] unit view directions (broadcast over samples),
    sdf: [...], gradients: [..., 3], dist: scalar world-metric step.
    """
    inv_s = 1.0 / s_val
    true_cos = torch.sum(viewdirs * gradients, dim=-1)
    iter_cos = -torch.clamp(-true_cos, min=0.0)          # always non-positive
    est_next = sdf + iter_cos * dist * 0.5
    est_prev = sdf - iter_cos * dist * 0.5
    # torch.sigmoid, not 1/(1+exp(-x)): the naive form overflows in the backward
    prev_cdf = torch.sigmoid(est_prev * inv_s)
    next_cdf = torch.sigmoid(est_next * inv_s)
    return torch.clamp((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5), 0.0, 1.0)


class CompositeOutput(NamedTuple):
    rgb: torch.Tensor            # [B, R, 3]
    rgb_var: torch.Tensor        # [B, R, 1]
    depth: torch.Tensor          # [B, R, 1]
    depth_var: torch.Tensor      # [B, R, 1]
    opacity: torch.Tensor        # [B, R, 1]
    weights: torch.Tensor        # [B, R, N, 1]
    all_cumulated: torch.Tensor  # [B, R] transmittance surviving to the second-to-last sample


def nerf_composite(rgb_samples: torch.Tensor, density_samples: torch.Tensor,
                   depth_samples: torch.Tensor, ray: torch.Tensor,
                   setbg_opaque: bool = False) -> CompositeOutput:
    """Quadrature volume rendering.

    rgb_samples [B, R, N, 3], density_samples [B, R, N], depth_samples
    [B, R, N, 1], ray [B, R, 3] (non-normalised: its norm turns depth
    intervals into distances).
    """
    ray_length = torch.linalg.norm(ray, dim=-1, keepdim=True)
    depth_intv = depth_samples[..., 1:, 0] - depth_samples[..., :-1, 0]
    depth_intv = torch.cat([depth_intv, torch.full_like(depth_intv[..., :1], 1e10)], dim=-1)
    dist = depth_intv * ray_length
    sigma_delta = density_samples * dist
    alpha = 1.0 - torch.exp(-sigma_delta)
    T = torch.exp(-torch.cumsum(
        torch.cat([torch.zeros_like(sigma_delta[..., :1]), sigma_delta[..., :-1]], dim=-1),
        dim=-1))
    all_cumulated = T[..., -2]
    weights = (T * alpha)[..., None]
    depth = (depth_samples * weights).sum(-2)
    depth_var = (weights * (depth_samples - depth[..., None, :]) ** 2).sum(-2)
    rgb = (rgb_samples * weights).sum(-2)
    rgb_var = ((rgb_samples - rgb[..., None, :]).sum(-1, keepdim=True) * weights).sum(-2)
    opacity = weights.sum(-2)
    if setbg_opaque:
        rgb = rgb + (1.0 - opacity)
    return CompositeOutput(rgb=rgb, rgb_var=rgb_var, depth=depth, depth_var=depth_var,
                           opacity=opacity, weights=weights, all_cumulated=all_cumulated)
