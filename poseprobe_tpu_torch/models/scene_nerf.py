"""Scene branch: frequency-encoded MLP NeRF (coarse + fine) with BARF c2f PE.

Port of `poseprobe_tpu/models/scene_nerf.py`. Parameters are plain nested
dicts of tensors in the JAX layout ({'feat': [{'w': [in, out], 'b'}...],
'rgb': [...]}). With ``matmul_dtype="bfloat16"`` the trunk runs through the
hand-written Hopper kernel (`ops/fused_mlp.py`) when its tensors are on
CUDA, and takes the encoding as its padded bf16 input tile, written by a
kernel of its own (`pe.posenc_scene_padded`); otherwise through the plain
encoding and the plain layer loop below.

The renders mark their stages for a profiler (`utils/profiling.span`):
`poseprobe.scene.sample`, `.encode`, `.trunk`, `.head` and `.composite`.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from ..core import rays as rays_mod
from ..core.tree import tree_map
from ..ops import compositing, fused_mlp, pe, ray_sampling
from ..utils.profiling import span
from .mlp import init_linear


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    """Static scene-branch config (same fields and defaults as the reference)."""

    layers_feat: tuple = (256,) * 8
    layers_rgb: tuple = (128, 3)
    skip: tuple = (4,)
    L_3D: int = 10
    L_view: int = 4
    add_raw_3d: bool = True
    add_raw_rays: bool = True
    include_pi: bool = True
    density_activ: str = "softplus"
    view_dep: bool = True
    barf_c2f: tuple | None = (0.4, 0.7)
    sample_intvs: int = 128
    sample_intvs_fine: int = 128
    fine_sampling: bool = True
    depth_param: str = "metric"
    rand_rays: int = 1024
    setbg_opaque: bool = False
    max_iter: int = 60000
    ratio_start_fine_sampling_at_x: float | None = 0.3
    # "bfloat16": bf16 trunk and rgb head with f32 master weights (one cast of
    # the param tree per step); everything outside the MLP stays float32
    matmul_dtype: str = "float32"
    # bf16 trunk on CUDA goes through the fused kernels when `supports(cfg)`, as the
    # reference's does: one width, a multiple of 128, one skip, input up to 128
    use_fused_trunk: bool = True

    @property
    def input_3d_dim(self) -> int:
        return (3 if self.add_raw_3d else 0) + 6 * self.L_3D

    @property
    def input_view_dim(self) -> int:
        return (3 if self.add_raw_rays else 0) + 6 * self.L_view


def init_nerf_mlp(generator: torch.Generator, cfg: SceneConfig) -> dict:
    """One NeRF MLP (coarse or fine), tensorflow-style init."""
    feat_layers = []
    dims = list(cfg.layers_feat)
    for li, d_out in enumerate(dims):
        k_in = cfg.input_3d_dim if li == 0 else dims[li - 1]
        if li in cfg.skip:
            k_in += cfg.input_3d_dim
        last = li == len(dims) - 1
        layer = init_linear(generator, k_in, d_out + 1 if last else d_out, "xavier_relu")
        if last:
            # the density column takes the plain xavier bound (no ReLU gain)
            layer["w"][:, :1] /= 2.0 ** 0.5
        feat_layers.append(layer)
    rgb_layers = []
    d_in = dims[-1] + (cfg.input_view_dim if cfg.view_dep else 0)
    for li, d_out in enumerate(cfg.layers_rgb):
        scheme = "xavier" if li == len(cfg.layers_rgb) - 1 else "xavier_relu"
        rgb_layers.append(init_linear(generator, d_in, d_out, scheme))
        d_in = d_out
    return {"feat": feat_layers, "rgb": rgb_layers}


def init_scene_params(generator: torch.Generator, cfg: SceneConfig, device="cuda") -> dict:
    params = {"nerf": init_nerf_mlp(generator, cfg)}
    if cfg.fine_sampling:
        params["nerf_fine"] = init_nerf_mlp(generator, cfg)
    return tree_map(lambda t: t.to(device), params)


def cast_mlp_params(params: dict, dtype: str):
    """Cast the param tree to the compute dtype (no-op unless "bfloat16");
    gradients come back float32 through the cast."""
    if dtype != "bfloat16":
        return params
    return tree_map(lambda t: t.to(torch.bfloat16), params)


def _mm(x: torch.Tensor, w: torch.Tensor, b=None):
    """[..., K] @ [K, N] (+ bias) in the operands' dtype."""
    out = x @ w
    return out if b is None else out + b


def _fused(cfg: SceneConfig, points: torch.Tensor) -> bool:
    """True where the trunk runs through the fused kernels: a bf16 trunk they
    take (`fused_mlp.supports`) on CUDA tensors."""
    return (cfg.use_fused_trunk and cfg.matmul_dtype == "bfloat16" and points.is_cuda
            and fused_mlp.supports(cfg))


def nerf_forward(mlp: dict, cfg: SceneConfig, points: torch.Tensor, ray: torch.Tensor,
                 progress) -> dict:
    """MLP prediction at [B, R, S, 3] points with [B, R, 3] ray directions.

    Returns dict(rgb_samples [B,R,S,3], density_samples [B,R,S]) in float32.
    """
    cdt = torch.bfloat16 if cfg.matmul_dtype == "bfloat16" else torch.float32
    fused = _fused(cfg, points)
    mlp = cast_mlp_params(mlp, cfg.matmul_dtype)
    with span("poseprobe.scene.encode"):
        if fused:
            enc = pe.posenc_scene_padded(points, cfg.L_3D, progress, cfg.barf_c2f,
                                         fused_mlp.in_pad(cfg.input_3d_dim), include_pi=cfg.include_pi,
                                         add_raw=cfg.add_raw_3d)
        else:
            enc = pe.posenc_scene(points, cfg.L_3D, progress, cfg.barf_c2f,
                                  include_pi=cfg.include_pi, add_raw=cfg.add_raw_3d).to(cdt)
        if cfg.view_dep:
            # the view encoding is constant along the samples axis: encode per
            # ray and push it through the first rgb matmul before broadcasting
            ray_unit = ray / (torch.linalg.norm(ray, dim=-1, keepdim=True) + 1e-12)
            ray_enc = pe.posenc_scene(ray_unit, cfg.L_view, progress, cfg.barf_c2f,
                                      include_pi=cfg.include_pi, add_raw=cfg.add_raw_rays).to(cdt)
    with span("poseprobe.scene.trunk"):
        if fused:
            raw_density, feat = fused_mlp.fused_trunk(enc, mlp["feat"], cfg.skip[0])
        else:
            feat = enc
            for li, layer in enumerate(mlp["feat"]):
                if li in cfg.skip:
                    feat = torch.cat([feat, enc], dim=-1)
                feat = _mm(feat, layer["w"], layer["b"])
                if li == len(mlp["feat"]) - 1:
                    raw_density = feat[..., 0].float()
                    feat = feat[..., 1:]
                feat = torch.relu(feat)
        del enc             # the trunk's input alone: without a graph (a render) it goes before the head
    with span("poseprobe.scene.head"):
        density = F.softplus(raw_density) if cfg.density_activ == "softplus" else torch.relu(raw_density)
        if cfg.view_dep:
            first = mlp["rgb"][0]
            feat_dim = feat.shape[-1]
            h = _mm(feat, first["w"][:feat_dim], first["b"])
            h = h + _mm(ray_enc, first["w"][feat_dim:])[..., None, :]
            for layer in mlp["rgb"][1:]:
                h = _mm(torch.relu(h), layer["w"], layer["b"])
        else:
            h = feat
            for li, layer in enumerate(mlp["rgb"]):
                if li > 0:
                    h = torch.relu(h)
                h = _mm(h, layer["w"], layer["b"])
        rgb = torch.sigmoid(h.float())
    return {"rgb_samples": rgb, "density_samples": density}


def render_rays(params: dict, cfg: SceneConfig, center: torch.Tensor, ray: torch.Tensor,
                depth_range, progress, noise: dict | None, compute_fine: bool) -> dict[str, Any]:
    """Coarse (+ optional fine) rendering of rays [B, R, 3].

    `noise`: the render's draws (`ray_sampling.draw_render_noise`), or None
    for the deterministic sampling of evaluation. The fine resampling is
    taken without gradient.
    """
    B, R = ray.shape[:2]
    depth_min, depth_max = depth_range
    noise = noise or {}
    with span("poseprobe.scene.sample"):
        depth_samples = ray_sampling.sample_depth_stratified(
            noise.get("jitter"), B, R, cfg.sample_intvs, depth_min, depth_max,
            param=cfg.depth_param, device=ray.device)
        points = rays_mod.get_3d_points_from_depth(center, ray, depth_samples, multi_samples=True)
    pred = nerf_forward(params["nerf"], cfg, points, ray, progress)
    with span("poseprobe.scene.composite"):
        out_c = compositing.nerf_composite(pred["rgb_samples"], pred["density_samples"],
                                           depth_samples, ray, setbg_opaque=cfg.setbg_opaque)
    result = {
        "rgb": out_c.rgb, "rgb_var": out_c.rgb_var, "depth": out_c.depth,
        "depth_var": out_c.depth_var, "opacity": out_c.opacity, "weights": out_c.weights,
        "all_cumulated": out_c.all_cumulated, "t": depth_samples,
        "origins": center, "viewdirs": ray,
    }
    if cfg.fine_sampling and compute_fine:
        with span("poseprobe.scene.sample"):
            with torch.no_grad():
                depth_fine = ray_sampling.sample_depth_from_pdf(
                    noise.get("fine_grid"), out_c.weights[..., 0], cfg.sample_intvs,
                    cfg.sample_intvs_fine, depth_min, depth_max)
                if cfg.depth_param == "metric":
                    depth_all = ray_sampling.merge_sorted_depths(depth_samples, depth_fine)
                else:
                    depth_all = torch.sort(torch.cat([depth_samples, depth_fine], dim=-2),
                                           dim=-2).values
            points_f = rays_mod.get_3d_points_from_depth(center, ray, depth_all, multi_samples=True)
        pred_f = nerf_forward(params["nerf_fine"], cfg, points_f, ray, progress)
        with span("poseprobe.scene.composite"):
            out_f = compositing.nerf_composite(pred_f["rgb_samples"], pred_f["density_samples"],
                                               depth_all, ray, setbg_opaque=cfg.setbg_opaque)
        result.update({
            "rgb_fine": out_f.rgb, "rgb_var_fine": out_f.rgb_var, "depth_fine": out_f.depth,
            "depth_var_fine": out_f.depth_var, "opacity_fine": out_f.opacity,
            "weights_fine": out_f.weights, "all_cumulated_fine": out_f.all_cumulated,
            "t_fine": depth_all,
        })
    return result


def render_rays_to_max(params: dict, cfg: SceneConfig, center: torch.Tensor, ray: torch.Tensor,
                       depth_min, depth_max: torch.Tensor, progress,
                       compute_fine: bool) -> dict[str, Any]:
    """Render each ray only up to a per-ray max depth [B, R] (visibility);
    `all_cumulated` is the probability the ray reaches that depth unoccluded."""
    B, R = ray.shape[:2]
    with span("poseprobe.scene.sample"):
        depth_samples = ray_sampling.sample_depth_to_max(B, R, cfg.sample_intvs, depth_min, depth_max)
        points = rays_mod.get_3d_points_from_depth(center, ray, depth_samples, multi_samples=True)
    pred = nerf_forward(params["nerf"], cfg, points, ray, progress)
    with span("poseprobe.scene.composite"):
        out_c = compositing.nerf_composite(pred["rgb_samples"], pred["density_samples"],
                                           depth_samples, ray, setbg_opaque=cfg.setbg_opaque)
    result = {"all_cumulated": out_c.all_cumulated, "depth": out_c.depth, "opacity": out_c.opacity}
    if cfg.fine_sampling and compute_fine:
        pred_f = nerf_forward(params["nerf_fine"], cfg, points, ray, progress)
        with span("poseprobe.scene.composite"):
            out_f = compositing.nerf_composite(pred_f["rgb_samples"], pred_f["density_samples"],
                                               depth_samples, ray, setbg_opaque=cfg.setbg_opaque)
        result["all_cumulated_fine"] = out_f.all_cumulated
    return result
