"""Positional encodings with BARF coarse-to-fine masking.

Port of `poseprobe_tpu/ops/pe.py`. Scene branch (`posenc_scene`): layout
stack([sin, cos], -2) over [C, L] flattened, frequencies 2^k * pi. Object
branch (`posenc_object`): [sin(all C*L), cos(all C*L)], frequencies 2^k
(no pi). Each frequency is weighted by the BARF window at training progress
`progress`.
"""
from __future__ import annotations

import math

import torch


def barf_weights(progress, L: int, barf_c2f, device="cuda") -> torch.Tensor:
    """Per-frequency [L] weights in [0, 1] given progress in [0, 1]."""
    if barf_c2f is None:
        return torch.ones(L, dtype=torch.float32, device=device)
    start, end = barf_c2f
    alpha = (progress - start) / (end - start) * L
    k = torch.arange(L, dtype=torch.float32, device=device)
    return (1.0 - torch.cos(torch.clamp(alpha - k, 0.0, 1.0) * math.pi)) / 2.0


def posenc_object(x: torch.Tensor, L: int, progress, barf_c2f) -> torch.Tensor:
    """Object-branch PE: [..., C] -> [..., C + 2*C*L] = [x, masked(sin, cos)]."""
    freqs = 2.0 ** torch.arange(L, dtype=torch.float32, device=x.device)
    spec = (x[..., None] * freqs).reshape(x.shape[:-1] + (-1,))      # [..., C*L]
    enc = torch.cat([torch.sin(spec), torch.cos(spec)], dim=-1)      # [..., 2CL]
    w = barf_weights(progress, L, barf_c2f, device=x.device)
    enc = (enc.reshape(-1, L) * w).reshape(enc.shape)
    return torch.cat([x, enc], dim=-1)


def posenc_scene(x: torch.Tensor, L: int, progress, barf_c2f,
                 include_pi: bool = True, add_raw: bool = True) -> torch.Tensor:
    """[..., C] -> [..., (C +) 2*C*L]."""
    freqs = 2.0 ** torch.arange(L, dtype=torch.float32, device=x.device)
    if include_pi:
        freqs = freqs * math.pi
    spec = x[..., None] * freqs                                    # [..., C, L]
    enc = torch.stack([torch.sin(spec), torch.cos(spec)], dim=-2)  # [..., C, 2, L]
    enc = enc * barf_weights(progress, L, barf_c2f, device=x.device)
    enc = enc.reshape(x.shape[:-1] + (-1,))                        # [..., 2CL]
    if add_raw:
        return torch.cat([x, enc], dim=-1)
    return enc
