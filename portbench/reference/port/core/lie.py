"""SO(3)/SE(3) exponential maps for camera pose refinement.

Port of `poseprobe_tpu/core/lie.py` (the slice's subset). The sin(x)/x-style
coefficients are even Taylor series evaluated from theta^2, so no sqrt is
taken: `se3_refine` starts at exactly zero, where d|w|/dw is undefined and a
sqrt would poison the pose gradient.
"""
from __future__ import annotations

import torch

_TAYLOR_TERMS = 10


def skew(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] skew-symmetric matrix."""
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(w0)
    return torch.stack([
        torch.stack([zeros, -w2, w1], dim=-1),
        torch.stack([w2, zeros, -w0], dim=-1),
        torch.stack([-w1, w0, zeros], dim=-1),
    ], dim=-2)


def _taylor_sq(x_sq: torch.Tensor, kind: str, nth: int = _TAYLOR_TERMS) -> torch.Tensor:
    """Taylor A = sin(x)/x, B = (1-cos x)/x^2, C = (x-sin x)/x^3 from x^2."""
    ans = torch.zeros_like(x_sq)
    denom = 1.0
    for i in range(nth + 1):
        if kind == "A":
            if i > 0:
                denom *= (2 * i) * (2 * i + 1)
        elif kind == "B":
            denom *= (2 * i + 1) * (2 * i + 2)
        else:  # "C"
            denom *= (2 * i + 2) * (2 * i + 3)
        ans = ans + (-1) ** i * x_sq ** i / denom
    return ans


def so3_to_SO3(w: torch.Tensor) -> torch.Tensor:
    """Exponential map so(3) -> SO(3). [..., 3] -> [..., 3, 3]."""
    wx = skew(w)
    theta_sq = (w * w).sum(-1)[..., None, None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    A = _taylor_sq(theta_sq, "A")
    B = _taylor_sq(theta_sq, "B")
    return eye + A * wx + B * (wx @ wx)


def se3_to_SE3(wu: torch.Tensor) -> torch.Tensor:
    """Exponential map se(3) -> SE(3). [..., 6] -> [..., 3, 4]."""
    w, u = wu[..., :3], wu[..., 3:]
    wx = skew(w)
    theta_sq = (w * w).sum(-1)[..., None, None]
    eye = torch.eye(3, dtype=wu.dtype, device=wu.device)
    A = _taylor_sq(theta_sq, "A")
    B = _taylor_sq(theta_sq, "B")
    C = _taylor_sq(theta_sq, "C")
    R = eye + A * wx + B * (wx @ wx)
    V = eye + B * wx + C * (wx @ wx)
    t = V @ u[..., None]
    return torch.cat([R, t], dim=-1)
