"""Object-branch losses.

Port of `poseprobe_tpu/losses/object.py`: masked MSE render loss, entropy on
the last transmittance, k0 total variation, eikonal constraint, deformation
priors with an exponentially decayed weight, a BCE mask loss on accumulated
weights, the boundary-shell positivity prior and the SDF-grid TV terms. All
work on the dense-masked output of `models.object_sdf.render`.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from ..ops import grid as grid_ops, tensorf
from .common import mse2psnr

_abs = grid_ops.abs_one_sided   # |x| with the reference's derivative (+1) at exactly 0


def dynamic_weight(initial: float, final: float, iteration, total: int) -> torch.Tensor:
    """initial * exp(log(final/initial)/total * it), in float32 at a number
    or a 0-dim tensor `iteration`."""
    decay_rate = math.log(final / initial) / max(total, 1)
    return initial * torch.exp(decay_rate * torch.as_tensor(iteration, dtype=torch.float32))


def rendering_loss(rgb_marched: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked MSE, normalized by mask area."""
    se = ((rgb_marched - target) * mask) ** 2
    return se.sum() / (mask.sum() * 3.0 + 1e-9)


def object_losses(render_out: dict[str, Any], target: torch.Tensor, mask: torch.Tensor,
                  iteration, total_iterations: int, weight_main: float = 1.0,
                  weight_mask: float = 0.1, weight_tv_k0: float = 0.0, k0_tv_value=None,
                  use_deform: bool = True, deform_prior_init: float = 1e-1,
                  deform_prior_final: float = 1e-3):
    """target [N, 3], mask [N, 1]. Returns (scalars dict, weights dict, total loss, psnr)."""
    scalars, weights = {}, {}

    scalars["img_render"] = rendering_loss(render_out["rgb_marched"], target, mask)
    weights["img_render"] = weight_main

    pout = torch.clamp(render_out["alphainv_cum"], 1e-6, 1 - 1e-6)
    scalars["weight_entropy_last"] = -(pout * torch.log(pout) + (1 - pout) * torch.log(1 - pout)).mean()
    weights["weight_entropy_last"] = 0.01

    if weight_tv_k0 > 0 and k0_tv_value is not None:
        scalars["tv_k0"] = k0_tv_value
        weights["tv_k0"] = weight_tv_k0

    # eikonal on the SDF spatial gradients at the valid samples;
    # sqrt(sum + eps): exact-zero gradients must not NaN the backward
    gradient = render_out["gradient"]
    gnorm = torch.sqrt(torch.sum(gradient * gradient, dim=-1) + 1e-12)
    valid = render_out["mask"].to(gnorm.dtype)
    scalars["grad_constraint"] = (_abs(gnorm - 1.0) * valid).sum() / (valid.sum() + 1e-9)
    weights["grad_constraint"] = 1.0

    if use_deform:
        w = dynamic_weight(deform_prior_init, deform_prior_final, iteration, total_iterations)
        jd = render_out["grad_deform"]
        jac_norm = torch.sqrt(torch.sum(jd * jd, dim=-1) + 1e-12)            # [..., 3]
        scalars["grad_deform_constraint"] = (jac_norm * valid[..., None]).sum() / (valid.sum() * 3 + 1e-9)
        weights["grad_deform_constraint"] = w
        scalars["sdf_correct_constraint"] = ((_abs(render_out["sdf_correct"][..., 0]) * valid).sum()
                                             / (valid.sum() + 1e-9))
        weights["sdf_correct_constraint"] = w
        scalars["sdf_deform_constraint"] = ((_abs(render_out["sdf_deform"]) * valid).sum()
                                            / (valid.sum() + 1e-9))
        weights["sdf_deform_constraint"] = w

    cum = torch.clamp(render_out["cum_weights"], 1e-3, 1.0 - 1e-3)
    scalars["mask_render"] = -(mask * torch.log(cum) + (1 - mask) * torch.log(1 - cum)).mean()
    weights["mask_render"] = weight_mask

    total = 0.0
    for k, v in scalars.items():
        total = total + v * weights[k]
    return scalars, weights, total, mse2psnr(scalars["img_render"])


def shell_positivity_loss(sdf_grid: torch.Tensor, margin: float = 0.0) -> torch.Tensor:
    """Mean hinge penalty relu(margin - sdf) on the raw SDF grid's 1-voxel outer
    shell ([1, X, Y, Z]): keeps a sign change inside the box."""
    g = sdf_grid[0]
    faces = torch.cat([g[0].reshape(-1), g[-1].reshape(-1), g[:, 0].reshape(-1), g[:, -1].reshape(-1),
                       g[:, :, 0].reshape(-1), g[:, :, -1].reshape(-1)])
    return torch.relu(margin - faces).mean()


def object_tv_losses(params: dict, cfg, nonempty_mask=None, sdf_tv: float = 0.0,
                     smooth_grad_tv: float = 0.0, weight_tv_density: float = 0.0):
    """SDF-grid total-variation terms as one weighted scalar."""
    sdf = params["sdf_grid"]
    if weight_tv_density <= 0:
        return sdf.new_zeros(())
    total = 0.0
    if sdf_tv > 0:
        total = total + grid_ops.total_variation(sdf, nonempty_mask) / 2.0 / cfg.voxel_size * sdf_tv
    if smooth_grad_tv > 0:
        grad = grid_ops.sdf_gradient_grid(sdf, cfg.voxel_size)
        total = total + grid_ops.smooth_grad_tv(grad, _tv_smooth_kernel(sdf.device),
                                                nonempty_mask) * smooth_grad_tv
    return weight_tv_density * total


def k0_total_variation(params: dict, nonempty_mask=None) -> torch.Tensor:
    """TV of the color feature grid: the dense grid's, or the TensoRF
    planes' and vectors' smooth-L1 TV."""
    k0 = params["k0_grid"]
    if isinstance(k0, dict):
        return tensorf.tensorf_total_variation(k0)
    return grid_ops.total_variation(k0, nonempty_mask)


def _tv_smooth_kernel(device="cuda"):
    """Separable 1-D factor [1, 2, 1]/4 of the normalized 3x3x3 binomial kernel."""
    return grid_ops.binomial_kernel_1d(device)
