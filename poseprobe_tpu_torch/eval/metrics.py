"""Image quality metrics: PSNR, SSIM, depth error, LPIPS (weights-gated).

Port of `poseprobe_tpu/eval/metrics.py`. LPIPS needs pretrained VGG16 and
LPIPS linear-layer weights, read from the local .npz that
$POSEPROBE_LPIPS_WEIGHTS names; without them `lpips_fn` raises
`LPIPSUnavailable` (metrics are off the hot path). The VGG slices here also
feed the surface-feature maps (`eval/vgg_features.py`).
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((pred - gt) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def depth_abs_rmse(pred, gt, valid=None, scale: float = 1.0):
    """Depth abs error + RMSE on valid GT pixels (host numpy float64).

    The predicted depth is multiplied by the sim3 est->GT scale (the optimized
    geometry is valid up to a similarity); invalid GT (0) pixels are dropped.
    Returns (abs_e, rmse) floats; (nan, nan) if nothing is valid.
    """
    pred = _numpy(pred).astype(np.float64).reshape(-1) * float(scale)
    gt = _numpy(gt).astype(np.float64).reshape(-1)
    v = (gt > 0) if valid is None else _numpy(valid).reshape(-1).astype(bool)
    if not v.any():
        return float("nan"), float("nan")
    diff = gt[v] - pred[v]
    return float(np.abs(diff).mean()), float(np.sqrt((diff ** 2).mean()))


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _gaussian_window(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return g[:, None] * g[None, :]


def ssim(img0: torch.Tensor, img1: torch.Tensor, max_val: float = 1.0,
         filter_size: int = 11, filter_sigma: float = 1.5,
         k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """SSIM over [H, W, C] images: an 11x11 Gaussian window over the valid
    region, per channel, averaged."""
    w = _gaussian_window(filter_size, filter_sigma, img0.device)[None, None]

    def filt(x):                                        # [C, H, W] -> [C, H', W']
        return F.conv2d(x[:, None], w)[:, 0]

    a, b = img0.permute(2, 0, 1), img1.permute(2, 0, 1)
    mu0, mu1 = filt(a), filt(b)
    s00 = torch.clamp(filt(a * a) - mu0 ** 2, min=0)
    s11 = torch.clamp(filt(b * b) - mu1 ** 2, min=0)
    s01 = filt(a * b) - mu0 * mu1
    c1, c2 = (k1 * max_val) ** 2, (k2 * max_val) ** 2
    num = (2 * mu0 * mu1 + c1) * (2 * s01 + c2)
    den = (mu0 ** 2 + mu1 ** 2 + c1) * (s00 + s11 + c2)
    return (num / den).mean(dim=(1, 2)).mean()


_LPIPS_WEIGHTS_ENV = "POSEPROBE_LPIPS_WEIGHTS"


class LPIPSUnavailable(RuntimeError):
    pass


def lpips_available() -> bool:
    path = os.environ.get(_LPIPS_WEIGHTS_ENV, "")
    return bool(path) and os.path.exists(path)


def lpips_fn(img0, img1) -> float:
    """LPIPS(vgg-lin) from locally provided weights, on the images' device.

    Expects a .npz at $POSEPROBE_LPIPS_WEIGHTS holding the VGG16 conv weights
    (`features.N.weight/bias`) and the LPIPS linear layers
    (`lin{i}.model.1.weight`).
    """
    if not lpips_available():
        raise LPIPSUnavailable(
            f"LPIPS weights not found; set ${_LPIPS_WEIGHTS_ENV} to a local .npz")
    blobs = np.load(os.environ[_LPIPS_WEIGHTS_ENV])
    img0 = torch.as_tensor(img0, dtype=torch.float32)
    img1 = torch.as_tensor(img1, dtype=torch.float32, device=img0.device)
    with torch.no_grad():
        return float(_lpips_vgg(img0, img1, blobs))


_VGG_SLICES = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))
_IMAGENET_MEAN = (-0.030, -0.088, -0.188)
_IMAGENET_STD = (0.458, 0.448, 0.450)


def vgg_conv(x: torch.Tensor, blobs, li: int) -> torch.Tensor:
    """VGG16 conv layer `li` (3x3, SAME) + ReLU on [B, C, H, W]."""
    w = torch.as_tensor(blobs[f"features.{li}.weight"], dtype=torch.float32, device=x.device)
    b = torch.as_tensor(blobs[f"features.{li}.bias"], dtype=torch.float32, device=x.device)
    return torch.relu(F.conv2d(x, w, b, padding=w.shape[-1] // 2))


def _lpips_vgg(img0: torch.Tensor, img1: torch.Tensor, blobs) -> torch.Tensor:
    """Minimal VGG16-lin LPIPS forward (images [H, W, 3] in [0, 1])."""
    mean = torch.tensor(_IMAGENET_MEAN, device=img0.device)
    std = torch.tensor(_IMAGENET_STD, device=img0.device)

    def features(x):
        h = ((x * 2.0 - 1.0 - mean) / std).permute(2, 0, 1)[None]
        feats = []
        for si, slice_ids in enumerate(_VGG_SLICES):
            for li in slice_ids:
                h = vgg_conv(h, blobs, li)
            feats.append(h[0].permute(1, 2, 0))
            if si < len(_VGG_SLICES) - 1:
                h = F.max_pool2d(h, 2)
        return feats

    total = torch.zeros((), device=img0.device)
    for i, (a, b) in enumerate(zip(features(img0), features(img1))):
        a = a / (torch.linalg.norm(a, dim=-1, keepdim=True) + 1e-10)
        b = b / (torch.linalg.norm(b, dim=-1, keepdim=True) + 1e-10)
        lin = torch.as_tensor(blobs[f"lin{i}.model.1.weight"], dtype=torch.float32,
                              device=img0.device)[:, :, 0, 0]      # [1, C]
        total = total + (((a - b) ** 2) @ lin[0]).mean()
    return total
