"""VGG multi-layer feature maps (weights-gated) for the surface-feature loss.

Port of `poseprobe_tpu/eval/vgg_features.py`. With the VGG16 weights that
$POSEPROBE_LPIPS_WEIGHTS names, the maps are the first conv blocks of the
LPIPS network, resampled to the input resolution; without them, colour plus
two central-difference gradient channels (still a matching signal). Computed
once per trainer, on its device.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from .metrics import _VGG_SLICES, lpips_available, vgg_conv


def features_available() -> bool:
    return lpips_available()


def get_multi_features(images, layers: int = 2, device="cuda") -> torch.Tensor:
    """images [B, H, W, 3] -> feature maps [B, H, W, C] on `device`.

    VGG path: C = 64 + 128 for two layers; every block after the first is
    upsampled bilinearly with half-pixel centres (`jax.image.resize`'s
    "bilinear", which equals `F.interpolate(align_corners=False)` when it
    upsamples, as here). Fallback: C = 5 (RGB, d/dx, d/dy of the grey image;
    zero on the border columns / rows)."""
    images = torch.as_tensor(np.asarray(images), dtype=torch.float32, device=device)
    with torch.no_grad():
        if features_available():
            blobs = np.load(os.environ["POSEPROBE_LPIPS_WEIGHTS"])
            H, W = images.shape[1:3]
            h = (images * 2.0 - 1.0).permute(0, 3, 1, 2)
            feats = []
            for si, slice_ids in enumerate(_VGG_SLICES[:layers]):
                for li in slice_ids:
                    h = vgg_conv(h, blobs, li)
                feats.append(h if h.shape[2] == H else
                             F.interpolate(h, size=(H, W), mode="bilinear", align_corners=False))
                if si < layers - 1:
                    h = F.max_pool2d(h, 2)
            return torch.cat(feats, dim=1).permute(0, 2, 3, 1).contiguous()
        gray = images @ torch.tensor([0.299, 0.587, 0.114], device=images.device)
        gx = torch.zeros_like(gray)
        gy = torch.zeros_like(gray)
        gx[:, :, 1:-1] = (gray[:, :, 2:] - gray[:, :, :-2]) / 2
        gy[:, 1:-1] = (gray[:, 2:] - gray[:, :-2]) / 2
        return torch.cat([images, gx[..., None], gy[..., None]], dim=-1)
