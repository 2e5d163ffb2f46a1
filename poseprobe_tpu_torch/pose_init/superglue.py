"""SuperPoint + SuperGlue as `nn.Module`s.

Port of `poseprobe_tpu/pose_init/superglue.py`:

* SuperPoint: a VGG-style encoder (four conv blocks, max-pools between), a
  65-channel detector head (softmax over the 8x8 cells and a dustbin, depth
  to space), the reference's two-round NMS, the border cut, the top-K
  keypoints, and a 256-d descriptor head sampled bilinearly at them.
* SuperGlue: the keypoint-position MLP encoder, 9 x (self, cross) multi-head
  (4) attention layers over both keypoint sets, the final projection and the
  log-domain Sinkhorn with a learned dustbin score; mutual argmax matches.

The module trees mirror the reference's, so that a state_dict of the
published weights, or its flat `.npz` (`pose_init/convert.py`), loads with
``load_state_dict(strict=True)`` as it is. The BatchNorms run in eval mode
(their running statistics). Weights come from ``$POSEPROBE_SUPERGLUE_WEIGHTS``:
a directory with ``superpoint_v1`` and ``superglue_{indoor,outdoor}`` as
``.npz`` or ``.pth``. The networks run on the card unless the caller passes
another device.

Two places where torch would differ from the reference unless told: the
top-K keeps the lower flat index first among equal scores (as `lax.top_k`
does; `torch.topk` on CUDA promises no order, and the zero scores of an image
with fewer maxima than K all tie), so it is a stable descending sort; and the
attention heads read the strided channels ``d * H + h``, on the way in and at
the merge, as the reference's ``view(b, dim, heads, n)`` does.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.geometry import bilinear_image_sample
from .matching import SUPERGLUE_WEIGHTS_ENV, _grayscale_u8

# ----------------------------------------------------------------- SuperPoint

_SP_CONVS = (("conv1a", 1, 64), ("conv1b", 64, 64), ("conv2a", 64, 64), ("conv2b", 64, 64),
             ("conv3a", 64, 128), ("conv3b", 128, 128), ("conv4a", 128, 128), ("conv4b", 128, 128))
_POOL_AFTER = ("conv1b", "conv2b", "conv3b")


class SuperPoint(nn.Module):
    """The reference's SuperPoint: `conv1a` ... `conv4b`, `convPa`/`convPb`
    (detector) and `convDa`/`convDb` (descriptor)."""

    def __init__(self):
        super().__init__()
        for name, cin, cout in _SP_CONVS:
            setattr(self, name, nn.Conv2d(cin, cout, 3, padding=1))
        self.convPa = nn.Conv2d(128, 256, 3, padding=1)
        self.convPb = nn.Conv2d(256, 65, 1)
        self.convDa = nn.Conv2d(128, 256, 3, padding=1)
        self.convDb = nn.Conv2d(256, 256, 1)

    def maps(self, image_gray: torch.Tensor):
        """image_gray [H, W] in [0, 1] -> (heat [8h, 8w], the detector's
        probabilities before NMS; desc_map [h, w, 256], L2-normalised)."""
        x = image_gray[None, None]
        for name, _, _ in _SP_CONVS:
            x = F.relu(getattr(self, name)(x))
            if name in _POOL_AFTER:
                x = F.max_pool2d(x, 2, 2)
        scores = self.convPb(F.relu(self.convPa(x)))[0]              # [65, h, w]
        scores = torch.softmax(scores, dim=0)[:64]
        _, h, w = scores.shape
        heat = scores.reshape(8, 8, h, w).permute(2, 0, 3, 1).reshape(h * 8, w * 8)
        desc = self.convDb(F.relu(self.convDa(x)))[0].permute(1, 2, 0)   # [h, w, 256]
        desc = desc / (torch.linalg.norm(desc, dim=-1, keepdim=True) + 1e-8)
        return heat, desc

    def forward(self, image_gray: torch.Tensor, nms_radius: int = 2, keypoint_threshold: float = 0.0,
                max_keypoints: int = 512):
        """-> (keypoints [K, 2] (x, y), scores [K], descriptors [K, 256]); K is
        fixed: zero-score keypoints pad an image with fewer maxima."""
        heat, desc_map = self.maps(image_gray)
        keypoints, scores = nms_topk(heat, nms_radius, keypoint_threshold, max_keypoints)
        return keypoints, scores, sample_descriptors(desc_map, keypoints)


def nms_topk(heat: torch.Tensor, nms_radius: int = 2, keypoint_threshold: float = 0.0,
             max_keypoints: int = 512):
    """Two-round NMS (suppression rounds that re-admit maxima outside the
    suppressed neighbourhoods), the threshold, a 4-pixel border cut and the
    top K of heat [H, W] -> (keypoints [K, 2] float (x, y), scores [K]).
    Equal scores keep the lower flat index first."""
    k = 2 * nms_radius + 1

    def maxpool(x):          # pads with -inf, as the reference's reduce_window does
        return F.max_pool2d(x[None, None], k, 1, padding=nms_radius)[0, 0]

    max_mask = heat == maxpool(heat)
    for _ in range(2):
        supp_mask = maxpool(max_mask.to(heat.dtype)) > 0
        supp_scores = torch.where(supp_mask, 0.0, heat)
        new_max_mask = supp_scores == maxpool(supp_scores)
        max_mask = max_mask | (new_max_mask & ~supp_mask)
    heat = torch.where(max_mask, heat, 0.0)
    heat = torch.where(heat > keypoint_threshold, heat, 0.0)
    b = 4
    heat = F.pad(heat[b:-b, b:-b], (b, b, b, b))
    top = torch.sort(heat.reshape(-1), descending=True, stable=True)
    scores, idx = top.values[:max_keypoints], top.indices[:max_keypoints]
    W = heat.shape[1]
    keypoints = torch.stack([(idx % W).to(torch.float32), (idx // W).to(torch.float32)], -1)
    return keypoints, scores


def sample_descriptors(desc_map: torch.Tensor, keypoints: torch.Tensor, s: float = 8.0) -> torch.Tensor:
    """Descriptors [K, 256] at keypoints [K, 2] from the 1/8-resolution map
    [h, w, 256]: the reference's align-corners coordinates
    u = (k - s/2 + 0.5) / (dim * s - s/2 - 0.5) * (dim - 1), bilinear, then
    L2-normalised."""
    hd, wd = desc_map.shape[:2]
    u = (keypoints[:, 0] - s / 2 + 0.5) / (wd * s - s / 2 - 0.5) * (wd - 1)
    v = (keypoints[:, 1] - s / 2 + 0.5) / (hd * s - s / 2 - 0.5) * (hd - 1)
    desc = bilinear_image_sample(desc_map, torch.stack([u, v], -1))
    return desc / (torch.linalg.norm(desc, dim=-1, keepdim=True) + 1e-8)


# ------------------------------------------------------------------ SuperGlue

def _mlp(channels) -> nn.Sequential:
    """Conv1d / BatchNorm1d / ReLU per layer, a bare Conv1d last: the module
    indices of the reference's `MLP` (conv at 0, 3, 6, ...; BN at 1, 4, ...)."""
    layers = []
    for i in range(1, len(channels)):
        layers.append(nn.Conv1d(channels[i - 1], channels[i], 1))
        if i < len(channels) - 1:
            layers += [nn.BatchNorm1d(channels[i]), nn.ReLU()]
    return nn.Sequential(*layers)


def _run_mlp(mlp: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """The MLP over [N, C] rows, its BatchNorms from their running statistics
    (eps 1e-5) in the reference's order of operations."""
    for m in mlp:
        if isinstance(m, nn.Conv1d):
            x = F.linear(x, m.weight[:, :, 0], m.bias)
        elif isinstance(m, nn.BatchNorm1d):
            x = (x - m.running_mean) / torch.sqrt(m.running_var + 1e-5) * m.weight + m.bias
        else:
            x = F.relu(x)
    return x


class _KeypointEncoder(nn.Module):
    def __init__(self, dims=(32, 64, 128, 256), feature_dim: int = 256):
        super().__init__()
        self.encoder = _mlp((3,) + tuple(dims) + (feature_dim,))


class _MultiHeadedAttention(nn.Module):
    def __init__(self, num_heads: int = 4, d_model: int = 256):
        super().__init__()
        self.num_heads, self.d_model = num_heads, d_model
        self.merge = nn.Conv1d(d_model, d_model, 1)
        self.proj = nn.ModuleList([nn.Conv1d(d_model, d_model, 1) for _ in range(3)])

    def forward(self, x: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
        """x [N, D], source [M, D] -> the message [N, D]."""
        H, D = self.num_heads, self.d_model

        def proj(conv, inp):        # head h reads channels d * H + h
            out = F.linear(inp, conv.weight[:, :, 0], conv.bias)
            return out.reshape(-1, D // H, H).permute(2, 0, 1)          # [H, N, D/H]

        q, k, v = proj(self.proj[0], x), proj(self.proj[1], source), proj(self.proj[2], source)
        scores = torch.einsum("hnd,hmd->hnm", q, k) / (D // H) ** 0.5
        msg = torch.einsum("hnm,hmd->hnd", torch.softmax(scores, dim=-1), v)
        msg = msg.permute(1, 2, 0).reshape(-1, D)                         # channel d * H + h
        return F.linear(msg, self.merge.weight[:, :, 0], self.merge.bias)


class _AttentionalPropagation(nn.Module):
    def __init__(self, feature_dim: int = 256, num_heads: int = 4):
        super().__init__()
        self.attn = _MultiHeadedAttention(num_heads, feature_dim)
        self.mlp = _mlp((feature_dim * 2, feature_dim * 2, feature_dim))

    def forward(self, x: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
        """x + MLP([x || message]) (the residual the reference's GNN adds)."""
        return x + _run_mlp(self.mlp, torch.cat([x, self.attn(x, source)], dim=-1))


class _AttentionalGNN(nn.Module):
    def __init__(self, feature_dim: int = 256, layer_names=("self", "cross") * 9):
        super().__init__()
        self.names = tuple(layer_names)
        self.layers = nn.ModuleList([_AttentionalPropagation(feature_dim, 4) for _ in self.names])

    def forward(self, x0: torch.Tensor, x1: torch.Tensor):
        for layer, name in zip(self.layers, self.names):
            src0, src1 = (x0, x1) if name == "self" else (x1, x0)
            x0, x1 = layer(x0, src0), layer(x1, src1)
        return x0, x1


def log_sinkhorn(scores: torch.Tensor, alpha: torch.Tensor, iters: int) -> torch.Tensor:
    """Log-domain Sinkhorn over scores [m, n] with a dustbin row and column of
    score `alpha`; marginals 1 per point and n (m) for the dustbins, all
    normalised by m + n. Returns the log assignment [m+1, n+1]."""
    m, n = scores.shape
    dev = scores.device
    alpha = alpha.to(scores.dtype)
    couplings = torch.cat([torch.cat([scores, alpha.expand(m, 1)], -1),
                           torch.cat([alpha.expand(1, n), alpha.expand(1, 1)], -1)], 0)
    norm = -torch.log(torch.tensor(float(m + n), dtype=torch.float32, device=dev))
    log_mu = torch.cat([norm.expand(m), (norm + float(np.log(n)))[None]])
    log_nu = torch.cat([norm.expand(n), (norm + float(np.log(m)))[None]])
    u = torch.zeros(m + 1, device=dev)
    v = torch.zeros(n + 1, device=dev)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(couplings + v[None, :], dim=1)
        v = log_nu - torch.logsumexp(couplings + u[:, None], dim=0)
    return couplings + u[:, None] + v[None, :] - norm


def mutual_matches(Z: torch.Tensor, match_threshold: float = 0.2):
    """Mutual-argmax matches of a log assignment [m+1, n+1] (dustbins last):
    (matches0 [m], -1 where none; mscores0 [m], exp(max) where mutual)."""
    Z = Z[:-1, :-1]
    max0, idx0 = Z.max(dim=1)
    idx1 = Z.argmax(dim=0)
    mutual = torch.arange(Z.shape[0], device=Z.device) == idx1[idx0]
    mscores = torch.where(mutual, torch.exp(max0), 0.0)
    valid = mutual & (mscores > match_threshold)
    return torch.where(valid, idx0, -1), mscores


class SuperGlue(nn.Module):
    """The reference's SuperGlue: `kenc`, `gnn`, `final_proj`, `bin_score`."""

    def __init__(self, descriptor_dim: int = 256):
        super().__init__()
        self.descriptor_dim = descriptor_dim
        self.kenc = _KeypointEncoder(feature_dim=descriptor_dim)
        self.gnn = _AttentionalGNN(descriptor_dim)
        self.final_proj = nn.Conv1d(descriptor_dim, descriptor_dim, 1)
        self.bin_score = nn.Parameter(torch.tensor(1.0))

    def log_assignment(self, kpts0, scores0, desc0, kpts1, scores1, desc1, image_shape,
                       sinkhorn_iterations: int = 20) -> torch.Tensor:
        """Keypoints [N, 2], scores [N] and descriptors [N, 256] of two images
        of shape (H, W) -> the log assignment [N0+1, N1+1]."""
        H, W = image_shape
        center = torch.tensor([W / 2.0, H / 2.0], dtype=torch.float32, device=kpts0.device)
        scaling = 0.7 * max(H, W)

        def enc(kpts, scores, desc):
            inp = torch.cat([(kpts - center) / scaling, scores[:, None]], -1)
            return desc + _run_mlp(self.kenc.encoder, inp)

        x0, x1 = self.gnn(enc(kpts0, scores0, desc0), enc(kpts1, scores1, desc1))
        wf, bf = self.final_proj.weight[:, :, 0], self.final_proj.bias
        m0, m1 = F.linear(x0, wf, bf), F.linear(x1, wf, bf)
        scores = torch.einsum("nd,md->nm", m0, m1) / self.descriptor_dim ** 0.5
        return log_sinkhorn(scores, self.bin_score, sinkhorn_iterations)

    def forward(self, kpts0, scores0, desc0, kpts1, scores1, desc1, image_shape,
                sinkhorn_iterations: int = 20, match_threshold: float = 0.2):
        """-> (matches0 [N0], mscores0 [N0])."""
        Z = self.log_assignment(kpts0, scores0, desc0, kpts1, scores1, desc1, image_shape,
                                sinkhorn_iterations)
        return mutual_matches(Z, match_threshold)


# ------------------------------------------------------------------- weights

_CACHE: dict = {}


def _read_checkpoint(path: str) -> dict:
    """A flat state_dict of numpy arrays from a converted ``.npz`` or a torch
    ``.pth`` (read with ``weights_only=True``)."""
    from .convert import load_npz, read_pth

    return load_npz(path) if path.endswith(".npz") else read_pth(path)


def _find(root: str, stem: str) -> str | None:
    for ext in (".npz", ".pth"):
        p = os.path.join(root, stem + ext)
        if os.path.exists(p):
            return p
    return None


def _build(cls, arrays: dict, device) -> nn.Module:
    net = cls()
    net.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in arrays.items()}, strict=True)
    return net.eval().to(device)


def load_networks(device="cuda", variant: str = "indoor"):
    """(SuperPoint, SuperGlue) from ``$POSEPROBE_SUPERGLUE_WEIGHTS`` on
    `device`, in eval mode. Cached by the files read and the device, so a
    changed path never serves stale weights. SuperGlue is the `variant`
    (indoor / outdoor) where present, else the other."""
    root = os.environ[SUPERGLUE_WEIGHTS_ENV]
    if not os.path.isdir(root):
        raise FileNotFoundError(f"${SUPERGLUE_WEIGHTS_ENV}={root} is not a directory holding "
                                "superpoint_v1 and superglue_{indoor,outdoor} (.npz or .pth)")
    sp_path = _find(root, "superpoint_v1")
    sg_paths = [p for p in (_find(root, f"superglue_{v}") for v in (variant, "indoor", "outdoor")) if p]
    if sp_path is None or not sg_paths:
        raise FileNotFoundError(f"${SUPERGLUE_WEIGHTS_ENV}={root}: superpoint_v1 or superglue_* missing")
    key = (os.path.realpath(sp_path), os.path.realpath(sg_paths[0]), str(torch.device(device)))
    if key not in _CACHE:
        _CACHE[key] = (_build(SuperPoint, _read_checkpoint(sp_path), device),
                       _build(SuperGlue, _read_checkpoint(sg_paths[0]), device))
    return _CACHE[key]


def match_pair_superglue(img_i: np.ndarray, img_j: np.ndarray, mask_j, max_matcher: int = 256,
                         variant: str = "indoor", match_threshold: float = 0.2,
                         device="cuda") -> np.ndarray:
    """SuperPoint + SuperGlue on one pair -> the padded [max_matcher, 5] pack
    (x_j, y_j, x_i, y_i, conf): image0 is the paired view j, its keypoints
    kept inside view j's object mask, matches in descending confidence."""
    sp, sg = load_networks(device, variant)
    with torch.no_grad():
        g_i = torch.as_tensor(_grayscale_u8(img_i), device=device).to(torch.float32) / 255.0
        g_j = torch.as_tensor(_grayscale_u8(img_j), device=device).to(torch.float32) / 255.0
        k_j, s_j, d_j = sp(g_j)
        k_i, s_i, d_i = sp(g_i)
        matches0, mscores = sg(k_j, s_j, d_j, k_i, s_i, d_i, tuple(g_j.shape),
                               match_threshold=match_threshold)
    matches0, mscores = matches0.cpu().numpy(), mscores.cpu().numpy()
    k_j, k_i = k_j.cpu().numpy(), k_i.cpu().numpy()
    valid = matches0 > -1
    if mask_j is not None:
        mj = np.asarray(mask_j).squeeze()
        ys = np.clip(k_j[:, 1].astype(int), 0, mj.shape[0] - 1)
        xs = np.clip(k_j[:, 0].astype(int), 0, mj.shape[1] - 1)
        valid &= mj[ys, xs] > 0
    pack = np.zeros((max_matcher, 5), np.float32)
    sel = np.where(valid)[0]
    sel = sel[np.argsort(-mscores[sel])][:max_matcher]
    m = len(sel)
    pack[:m, 0:2] = k_j[sel]
    pack[:m, 2:4] = k_i[matches0[sel]]
    pack[:m, 4] = mscores[sel]
    return pack
