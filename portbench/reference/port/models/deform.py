"""Implicit deformation field of the object pose-probe.

Port of `poseprobe_tpu/models/deform.py`: a ReLU MLP 3 -> 128 x (1 + 3
hidden) -> 4 whose output, scaled by ``output_range``, splits into a 3-D
coordinate offset and a scalar SDF correction. The last layer starts at zero,
so the field starts as the identity. `output_range` is a parameter leaf like
the layers (the reference optimizer updates it with the rest of `warpnet`).
"""
from __future__ import annotations

import torch

from .mlp import apply_mlp, init_mlp

HIDDEN = 128
NUM_HIDDEN_LAYERS = 3


def init_deform_params(generator: torch.Generator, output_range: float, device="cuda") -> dict:
    dims = [3] + [HIDDEN] * (NUM_HIDDEN_LAYERS + 1) + [4]
    layers = init_mlp(generator, dims, scheme="kaiming_normal", last_scheme="zeros")
    return {
        "layers": [{k: v.to(device) for k, v in la.items()} for la in layers],
        "output_range": torch.tensor(output_range, dtype=torch.float32, device=device),
    }


def apply_deform(params: dict, pts: torch.Tensor):
    """pts [..., 3] -> (deform [..., 3], correction [..., 1])."""
    out = apply_mlp(params["layers"], pts) * params["output_range"]
    return out[..., :3], out[..., 3:]


def deform_with_jacobian_fwd(params: dict, pts: torch.Tensor):
    """One shared forward pass for the primal and all three basis tangents
    (the ReLU masks are computed once and reused).

    Returns (deform [..., 3], correction [..., 1],
             jac_warp [..., 3, 3] with jac[..., j, i] = d(pts+deform)_i/d pts_j,
             grad_corr [..., 3]).
    """
    layers = params["layers"]
    scale = params["output_range"]
    h = pts
    eye = torch.eye(3, dtype=pts.dtype, device=pts.device)
    tang = eye.expand(pts.shape[:-1] + (3, 3))                  # [..., 3(in), 3]
    pre = h
    for i, layer in enumerate(layers):
        w, b = layer["w"], layer["b"]
        pre = h @ w + b                                          # [..., out]
        tang = tang @ w                                          # [..., 3(in), out]
        if i < len(layers) - 1:
            mask = pre > 0
            h = torch.where(mask, pre, 0.0)
            tang = torch.where(mask[..., None, :], tang, 0.0)
    out = pre * scale                                            # [..., 4]
    jac4 = tang * scale                                          # [..., 3(in), 4(out)]
    deform, correction = out[..., :3], out[..., 3:]
    jac_warp = jac4[..., :3] + eye
    grad_corr = jac4[..., 3]
    return deform, correction, jac_warp, grad_corr


def deform_with_jacobian(params: dict, pts: torch.Tensor):
    """(deform, correction, d(new_coords)/d(pts) [..., 3, 3]) with the Jacobian
    from autograd: the cross-check of `deform_with_jacobian_fwd`."""
    deform, correction = apply_deform(params, pts)
    p = pts.detach().requires_grad_(True)
    d, _ = apply_deform(params, p)
    cols = [torch.autograd.grad((p[..., i] + d[..., i]).sum(), p, retain_graph=True)[0]
            for i in range(3)]
    # jac[..., j, i] = d new_i / d pts_j
    return deform, correction, torch.stack(cols, dim=-1)
