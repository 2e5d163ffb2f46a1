"""Shared loss primitives. Port of `poseprobe_tpu/losses/common.py` (the
slice's subset)."""
from __future__ import annotations

import torch


def huber(diff: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """Elementwise Huber of diff vs zero (torch F.huber_loss semantics)."""
    a = diff.abs()
    return torch.where(a <= delta, 0.5 * diff ** 2, delta * (a - 0.5 * delta))


def compute_diff_loss(loss_type: str, diff: torch.Tensor, weights=None, mask=None,
                      delta: float = 1.0, dim: int = -1) -> torch.Tensor:
    """Weighted/masked reduction of a difference tensor: masked mean when a
    mask is given, plain mean otherwise."""
    lt = loss_type.lower()
    if lt == "epe":
        loss = torch.linalg.norm(diff, dim=dim, keepdim=True)
    elif lt == "l1":
        loss = diff.abs()
    elif lt == "mse":
        loss = diff ** 2
    elif lt == "huber":
        loss = huber(diff, delta)
    else:
        raise ValueError(loss_type)
    if weights is not None:
        loss = loss * weights
    if mask is not None:
        m = mask.to(loss.dtype)
        loss = loss * m
        return loss.sum() / (m.sum() + 1e-6)
    return loss.sum() / (loss.numel() + 1e-6)


def summarize_losses(loss_dict: dict, loss_weight: dict, parametrization: str = "exp"):
    """Sum of 10^w * loss (log-scale weights); a None weight drops the term."""
    total = 0.0
    for key, value in loss_dict.items():
        w = loss_weight.get(key)
        if w is None:
            continue
        total = total + (10.0 ** float(w) if parametrization == "exp" else float(w)) * value
    return total


def mse2psnr(mse) -> torch.Tensor:
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))
