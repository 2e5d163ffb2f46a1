"""Training CLI of the PyTorch port: the counterpart of the repository's `run.py`.

    python -m poseprobe_tpu_torch.run --config poseprobe_tpu_torch/config/presets/dtu_generic.py \
        --datadir /path/to/DTU/scan24 [--render_test] [--render_video] [--export_mesh] [--steps N]
    python -m poseprobe_tpu_torch.run --synthetic [--tiny] [--cpu]

Takes every flag of `run.py` under the same name, applies the same config
overrides, trains a `JointTrainer` with `fit(superstep=--superstep)` (on a
card, CUDA-graph windows between host events) and writes the same outputs
under ``cfg.basedir/cfg.expname``: `metrics.jsonl`, `best_ckpt.pkl` and
`last_ckpt.pkl` (format-v2 ``.npz`` archives despite the name, as in the
reference), the `--render_test` JSON, `train_renders/`, `meshes/` and the
spiral video. It runs on the card and raises without one, unless `--cpu` asks
for the CPU; the SuperGlue matcher (`--matcher superglue`, `--match_source
superglue`) runs its networks on the same device, with the weights in
``$POSEPROBE_SUPERGLUE_WEIGHTS``.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import inspect
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from .config import config as cfg_mod
from .core import align
from .data.loaders import load_data
from .data.png import write_png
from .eval import evaluator, mesh as mesh_mod, metrics as metrics_mod, video as video_mod
from .models import object_sdf
from .models.object_sdf import ObjectConfig
from .models.scene_nerf import SceneConfig
from .train import state as state_mod
from .train.trainer import JointTrainer
from .utils.logging import MetricsLogger
from .utils.vis import validation_panel

_PRESETS = Path(__file__).resolve().parent / "config" / "presets"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train PoseProbe with the PyTorch port.")
    p.add_argument("--config", type=str, default="",
                   help="path to a preset module exposing get_config()")
    p.add_argument("--datadir", type=str, default="")
    p.add_argument("--scene", type=str, default="",
                   help="scene/scan selector for family presets "
                        "(presets/{dtu_scan,replica_scene,toy_scene,"
                        "nerf_synthetic}.py), e.g. --scene room2 or --scene 30")
    p.add_argument("--synthetic", action="store_true",
                   help="use the procedural synthetic scene (no dataset needed)")
    p.add_argument("--steps", type=int, default=0,
                   help="override max_iter (run length AND schedule length; "
                        "see --schedule_steps)")
    p.add_argument("--schedule_steps", type=int, default=0,
                   help="with --steps: resolve ratio-based schedules (pose "
                        "windows, c2f, BA events) against this length instead "
                        "of --steps")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--render_test", action="store_true")
    p.add_argument("--render_train", action="store_true",
                   help="post-train renders + PSNR of the training views "
                        "(reference run.py render_viewpoints on the train split)")
    p.add_argument("--render_video", action="store_true")
    p.add_argument("--export_mesh", action="store_true")
    p.add_argument("--i_print", type=int, default=200)
    p.add_argument("--i_validate", type=int, default=5000)
    p.add_argument("--i_ckpt", type=int, default=5000)
    p.add_argument("--i_validate_mesh", type=int, default=0,
                   help="extract + save the object mesh every N steps (0 = off)")
    p.add_argument("--beta_cap", type=float, default=0.0,
                   help="cap the learned SDF-mapping beta at this value "
                        "(ObjectConfig.beta_cap; 2.0 = the init, blocks the "
                        "evaporation basin where beta rises while frac_neg "
                        "drains; 0 = off)")
    p.add_argument("--no_probe_check", action="store_true",
                   help="disable the default-on end-of-object-phase probe "
                        "health assertion (ProbeHealthError on an evaporated "
                        "or filled-box SDF grid); for probe-less experiments")
    p.add_argument("--grid_stats", action="store_true",
                   help="log raw SDF-grid stats (min/max/frac<0, alpha/beta) "
                        "into metrics.jsonl each log interval during the "
                        "object phase (collapse diagnosis)")
    p.add_argument("--no_test_optim", action="store_true",
                   help="skip test-time photometric pose optimization")
    p.add_argument("--matcher", type=str, default="auto",
                   choices=["auto", "superglue", "classical"])
    # schedule overrides for experimentation (mirror the reference's per-scene
    # N_iters / ratio_end_joint_nerf_pose_refinement knobs)
    p.add_argument("--object_iters", type=int, default=0,
                   help="override object-branch N_iters")
    p.add_argument("--n_views", type=int, default=0,
                   help="synthetic scene: number of training views (3-6)")
    p.add_argument("--fine_start", type=float, default=0.0,
                   help="override ratio_start_fine_sampling_at_x AND "
                        "start_ratio_depth_cons (the reference co-schedules "
                        "them with the pose window)")
    p.add_argument("--pose_window", type=float, default=0.0,
                   help="override ratio_end_joint_nerf_pose_refinement")
    p.add_argument("--superstep", type=int, default=100,
                   help="steps per window between host events: on a card one "
                        "captured CUDA graph replayed (1 = one eager step at a "
                        "time); numerically the same steps")
    p.add_argument("--matmul_dtype", type=str, default="",
                   choices=["", "float32", "bfloat16"],
                   help="override SceneConfig.matmul_dtype (bf16: the fused "
                        "trunk kernel, f32 master weights)")
    p.add_argument("--expname", type=str, default="",
                   help="override cfg.expname (output directory name)")
    p.add_argument("--arc_half", type=float, default=0.0,
                   help="synthetic scene: half-width of the camera arc in "
                        "radians (default: auto, ~14deg per view pair)")
    p.add_argument("--n_test", type=int, default=0,
                   help="synthetic scene: number of held-out test views "
                        "(default 4 — multi-sample PSNR statistics)")
    p.add_argument("--res", type=int, default=0,
                   help="synthetic scene: image H=W (default 64; raise for "
                        "real-matcher runs, which need texture detail)")
    p.add_argument("--match_source", type=str, default="analytic",
                   choices=["analytic", "classical", "superglue"],
                   help="synthetic scene: correspondence source — analytic "
                        "GT projections, or the REAL feature matcher run on "
                        "the rendered images (the reference's load-time flow, "
                        "load_dtu.py:126-155)")
    p.add_argument("--match_noise_px", type=float, default=0.0,
                   help="synthetic scene: Gaussian pixel noise added to "
                        "analytic match endpoints")
    p.add_argument("--match_outliers", type=float, default=0.0,
                   help="synthetic scene: fraction of matches replaced by "
                        "uniform random outliers at full confidence")
    p.add_argument("--texture", type=str, default="checker",
                   choices=["checker", "noise"],
                   help="synthetic scene: surface texture — 'noise' is the "
                        "distinctive value-noise texture the real-matcher "
                        "protocol needs (checker aliases SIFT)")
    p.add_argument("--probe", type=str, default="cube",
                   choices=["cube", "sphere"],
                   help="synthetic scene: pose-probe object shape (sphere "
                        "forces the deformation field to adapt the cube-SDF "
                        "init to a non-cube probe)")
    p.add_argument("--pnp_anchor", type=str, default="",
                   choices=["", "object", "scene", "object_scaled"],
                   help="activation-time PnP 3D-anchor source (see PnPConfig)")
    p.add_argument("--pose_ba", type=str, default="",
                   help="comma-separated max_iter ratios at which to run the "
                        "match-based bundle-adjustment pose polish "
                        "(CameraConfig.ba_at_ratios; try 0.25,0.45 — inside "
                        "the pose window so joint training absorbs the snap)")
    p.add_argument("--reregister", type=float, default=0.0,
                   help="re-register all poses against scene depth at this "
                        "ratio of max_iter (CameraConfig.reregister_at_ratio)")
    p.add_argument("--pose_warmup", type=int, default=0,
                   help="photometric pose-only steps for each newly "
                        "activated view (CameraConfig.activation_pose_warmup)")
    p.add_argument("--warmup_gate", type=float, default=0.0,
                   help="skip the warmup when PnP median reprojection error "
                        "<= this many px (CameraConfig.activation_warmup_gate_px)")
    p.add_argument("--warmup_photo_ratio", type=float, default=0.0,
                   help="photometric second opinion on the warmup gate + "
                        "accept-if-better guard (CameraConfig."
                        "activation_warmup_photo_ratio; try 4)")
    p.add_argument("--warmup_rot_only", action="store_true",
                   help="warmup optimizes rotation only, keeping PnP's "
                        "camera center (CameraConfig.activation_warmup_rot_only)")
    p.add_argument("--warmup_center_anchor", type=float, default=0.0,
                   help="soft camera-center anchor toward the PnP seed during "
                        "warmup (CameraConfig.activation_warmup_center_anchor; "
                        "try 1.0 — fixes depth-ambiguous t inflation)")
    p.add_argument("--warmup_holdout", type=float, default=0.0,
                   help="geometric second opinion: re-arm warmup when PnP's "
                        "holdout cross-validation error exceeds this many px "
                        "(CameraConfig.activation_warmup_holdout_px; try 2)")
    p.add_argument("--warmup_rescue", type=float, default=0.0,
                   help="catastrophic-PnP rescue: if the settled activation "
                        "pose renders worse than this ratio x the previous "
                        "view's MSE, fall back to the previous pose (+SE3 "
                        "warmup), photometric argmin "
                        "(CameraConfig.activation_rescue_ratio; try 10)")
    p.add_argument("--maskcache", action="store_true",
                   help="enable object-branch free-space skipping "
                        "(ObjectConfig.use_maskcache)")
    p.add_argument("--pg_scale", type=str, default="",
                   help="comma-separated step checkpoints for progressive grid "
                        "scaling: start at num_voxels/2^len, double the voxel "
                        "count at each step (ObjectTrainConfig.pg_scale, "
                        "reference configs/default_fine_s.py:70; try 500,1000)")
    p.add_argument("--grid_type", type=str, default="",
                   help="override ObjectConfig.grid_type: dense | tensorf "
                        "(VM-decomposed TensoRF grid)")
    p.add_argument("--pose_trans_window", type=float, default=0.0,
                   help="override SceneTrainConfig.ratio_end_pose_trans: keep "
                        "refining pose TRANSLATION until this ratio while "
                        "rotation freezes at --pose_window")
    p.add_argument("--tiny", action="store_true",
                   help="shrink grids/rays/samples/images for CPU smoke runs "
                        "(verify recipe; synthetic dataset only)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (tests); without it the run needs a "
                        "CUDA card")
    p.add_argument("--loss_weight", action="append", default=[],
                   help="override a scene log10 loss weight, e.g. "
                        "--loss_weight depth_cons=-2 (repeatable; 'none' "
                        "disables the term)")
    p.add_argument("--dc_start", type=float, default=0.0,
                   help="override start_ratio_depth_cons alone (without "
                        "touching the fine-sampling start)")
    p.add_argument("--fg_fraction", type=float, default=-1.0,
                   help="override sample_fraction_in_fg_mask")
    p.add_argument("--pose_noise", type=float, default=0.0,
                   help="seed poses = GT + se3 noise of this scale, PnP off "
                        "(the generic-DTU coarse protocol, coarse.py:36)")
    p.add_argument("--no_pnp", action="store_true",
                   help="seed poses from GT without PnP (replica/toy protocol)")
    p.add_argument("--incremental_step", type=int, default=0,
                   help="override CameraConfig.incremental_step (steps "
                        "between view activations)")
    p.add_argument("--shell_weight", type=float, default=0.0,
                   help="boundary-shell SDF positivity prior weight "
                        "(ObjectTrainConfig.weight_shell; blocks the "
                        "non-cube-probe filled-box basin)")
    p.add_argument("--shell_margin", type=float, default=0.0,
                   help="required raw-SDF margin at the bbox shell "
                        "(ObjectTrainConfig.shell_margin, world units)")
    return p


def resolve_device(cpu: bool) -> str:
    """"cpu" when asked for, else "cuda", which needs a card."""
    if cpu:
        return "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card; pass --cpu to run on the CPU")
    return "cuda"


def apply_steps_override(cfg, args):
    """Resolve --steps / --schedule_steps into the config's max_iters, so that
    every ratio-based schedule (pose windows, fine start, BARF c2f, BA and
    re-registration events) resolves against the run's length, or against
    --schedule_steps where given."""
    if not args.steps:
        return cfg
    sched = args.schedule_steps or args.steps
    return dataclasses.replace(cfg, scene_model=dataclasses.replace(cfg.scene_model, max_iter=sched),
                               scene_train=dataclasses.replace(cfg.scene_train, max_iter=sched))


def _load_preset(path: str):
    """A preset module from its file. The port's presets import their package
    relatively, so a file under `config/presets/` is imported as its module
    there, and any other file is run as a module of that package."""
    path = Path(path).resolve()
    if path.parent == _PRESETS:
        return importlib.import_module(f"poseprobe_tpu_torch.config.presets.{path.stem}")
    spec = importlib.util.spec_from_file_location(f"poseprobe_tpu_torch.config.presets.{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_config(args):
    """The experiment config: `--synthetic` (or no `--config`) gives the
    reference's synthetic-scene config; otherwise the preset file's
    `get_config`, with `--datadir` and `--scene` passed on."""
    if args.synthetic or not args.config:
        return cfg_mod.ExperimentConfig(
            expname="synthetic",
            data=cfg_mod.DataConfig(dataset_type="synthetic", near=0.5, far=8.5),
            object_model=ObjectConfig(xyz_min=(-0.56,) * 3, xyz_max=(0.56,) * 3, num_voxels=64 ** 3,
                                      num_voxels_base=64 ** 3, N_iters=4000, world_bound_scale=1.25),
            # joint pose refinement on (the generic-DTU regime)
            object_train=cfg_mod.ObjectTrainConfig(N_iters=4000, lr_pose=1e-3, lr_pose_end=1e-4),
            scene_model=SceneConfig(max_iter=20000),
            scene_train=cfg_mod.SceneTrainConfig(max_iter=20000),
            camera=cfg_mod.CameraConfig(incremental=True, incremental_step=400),
        )
    mod = _load_preset(args.config)
    kwargs = {}
    if args.datadir:
        kwargs["datadir"] = args.datadir
    if args.scene:
        params = inspect.signature(mod.get_config).parameters
        if "scene" in params:
            kwargs["scene"] = args.scene
        elif "scan_id" in params:
            kwargs["scan_id"] = int(args.scene)
        else:
            raise SystemExit(f"--scene given but {args.config} is not a family preset "
                             "(get_config has no scene/scan_id)")
    return mod.get_config(**kwargs)


def _sub(cfg, section: str, **kw):
    return dataclasses.replace(cfg, **{section: dataclasses.replace(getattr(cfg, section), **kw)})


def apply_overrides(cfg, args):
    """The reference's flag -> config overrides, in its order."""
    cfg = apply_steps_override(cfg, args)
    if args.seed is not None:
        cfg = dataclasses.replace(cfg, seed=args.seed)
    if args.shell_weight:
        cfg = _sub(cfg, "object_train", weight_shell=args.shell_weight, shell_margin=args.shell_margin)
    if args.object_iters:
        cfg = _sub(_sub(cfg, "object_model", N_iters=args.object_iters), "object_train",
                   N_iters=args.object_iters)
    if args.maskcache:
        cfg = _sub(cfg, "object_model", use_maskcache=True, maskcache_thres=0.1, maskcache_keep=0.5)
    if args.pose_window:
        cfg = _sub(cfg, "scene_train", ratio_end_joint_nerf_pose_refinement=args.pose_window)
    if args.fine_start:
        cfg = _sub(_sub(cfg, "scene_model", ratio_start_fine_sampling_at_x=args.fine_start),
                   "scene_train", start_ratio_depth_cons=args.fine_start)
    if args.pose_trans_window:
        cfg = _sub(cfg, "scene_train", ratio_end_pose_trans=args.pose_trans_window)
    if args.matmul_dtype:
        cfg = _sub(cfg, "scene_model", matmul_dtype=args.matmul_dtype)
    if args.expname:
        cfg = dataclasses.replace(cfg, expname=args.expname)
    if args.no_probe_check:
        cfg = _sub(cfg, "object_train", probe_health_check=False)
    if args.beta_cap:
        cfg = _sub(cfg, "object_model", beta_cap=args.beta_cap)
    if args.pnp_anchor:
        cfg = _sub(cfg, "pnp", anchor=args.pnp_anchor)
    if args.reregister:
        cfg = _sub(cfg, "camera", reregister_at_ratio=args.reregister)
    if args.pose_ba:
        cfg = _sub(cfg, "camera", ba_at_ratios=tuple(float(r) for r in args.pose_ba.split(",")))
    if args.pose_warmup:
        cfg = _sub(cfg, "camera", activation_pose_warmup=args.pose_warmup)
    if args.warmup_gate:
        cfg = _sub(cfg, "camera", activation_warmup_gate_px=args.warmup_gate)
    if args.warmup_photo_ratio:
        cfg = _sub(cfg, "camera", activation_warmup_photo_ratio=args.warmup_photo_ratio)
    if args.warmup_holdout:
        cfg = _sub(cfg, "camera", activation_warmup_holdout_px=args.warmup_holdout)
    if args.warmup_rot_only:
        cfg = _sub(cfg, "camera", activation_warmup_rot_only=True)
    if args.warmup_center_anchor:
        cfg = _sub(cfg, "camera", activation_warmup_center_anchor=args.warmup_center_anchor)
    if args.warmup_rescue:
        cfg = _sub(cfg, "camera", activation_rescue_ratio=args.warmup_rescue)
    if args.pg_scale:
        cfg = _sub(cfg, "object_train", pg_scale=tuple(int(s) for s in args.pg_scale.split(",")))
    if args.grid_type:
        cfg = _sub(cfg, "object_model", grid_type=args.grid_type)
    if args.incremental_step:
        cfg = _sub(cfg, "camera", incremental_step=args.incremental_step)
    if args.pose_noise:
        # GT poses + se3 noise, no PnP, joint pose refinement recovers the perturbation
        cfg = _sub(_sub(cfg, "camera", noise=args.pose_noise), "pnp", use_pnp=False)
    if args.no_pnp:
        cfg = _sub(cfg, "pnp", use_pnp=False)
    if args.loss_weight:
        lw = dict(cfg.scene_train.loss_weight)
        for item in args.loss_weight:
            name, _, val = item.partition("=")
            lw[name] = None if val.lower() == "none" else float(val)
        cfg = _sub(cfg, "scene_train", loss_weight=tuple(lw.items()))
    if args.dc_start:
        cfg = _sub(cfg, "scene_train", start_ratio_depth_cons=args.dc_start)
    if args.fg_fraction >= 0:
        cfg = _sub(cfg, "scene_train", sample_fraction_in_fg_mask=args.fg_fraction)
    if args.tiny:
        cfg = _sub(cfg, "object_model", num_voxels=32 ** 3, num_voxels_base=32 ** 3)
        cfg = _sub(cfg, "object_train", N_rand=128)
        cfg = _sub(cfg, "scene_model", rand_rays=128, sample_intvs=32, sample_intvs_fine=32)
    return cfg


def synthetic_loader_kwargs(cfg, args, run: bool) -> dict:
    """The synthetic scene's arguments from the flags (empty for a dataset);
    `run`: the training CLI's flags (the evaluation CLI has fewer)."""
    if cfg.data.dataset_type != "synthetic":
        return {}
    kw = {}
    if args.n_views:
        kw["n_train"] = args.n_views
    if args.probe != "cube":
        kw["probe"] = args.probe
    if args.n_test:
        kw["n_test"] = args.n_test
    if args.res:
        kw["H"] = kw["W"] = args.res
    if args.texture != "checker":
        kw["texture"] = args.texture
    if run:
        if args.match_source != "analytic":
            kw["match_source"] = args.match_source
        if args.arc_half:
            kw["arc_half"] = args.arc_half
        if args.match_noise_px:
            kw["match_noise_px"] = args.match_noise_px
        if args.match_outliers:
            kw["match_outlier_frac"] = args.match_outliers
        if args.tiny:
            kw["H"] = kw["W"] = 32
    return kw


def spiral_w2c(cur_w2c: np.ndarray, n: int) -> np.ndarray:
    """The spiral video's w2c poses around the optimized train cameras."""
    c2w = np.linalg.inv(np.concatenate(
        [cur_w2c, np.tile(np.array([[[0, 0, 0, 1.0]]]), (cur_w2c.shape[0], 1, 1))], axis=1))[:, :3]
    return np.stack([np.concatenate([s[:3, :3].T, (-s[:3, :3].T @ s[:3, 3])[:, None]], 1)
                     for s in video_mod.spiral_poses_from_trajectory(c2w, n=n)])


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.cpu)
    cfg = apply_overrides(load_config(args), args)

    out_dir = os.path.join(cfg.basedir, cfg.expname)
    os.makedirs(out_dir, exist_ok=True)
    print(f"[run] loading data ({cfg.data.dataset_type}) ...")
    data = load_data(cfg.data, matcher_backend=args.matcher, matcher_device=device,
                     **synthetic_loader_kwargs(cfg, args, run=True))
    print(f"[run] {data.n_train} train views, {len(data.i_test)} test views, {data.H}x{data.W}, on {device}")

    trainer = JointTrainer(cfg, data, device=device)
    logger = MetricsLogger(os.path.join(out_dir, "metrics.jsonl"))
    max_iter = args.steps or cfg.scene_train.max_iter
    poses_gt = data.poses_gt_w2c[data.i_train]
    t0 = time.time()
    basin_checked = []

    def save(name: str) -> None:
        state_mod.save_checkpoint(os.path.join(out_dir, name), trainer, configs={"expname": cfg.expname},
                                  extras=trainer.host_extras())

    def on_log(h):
        h["wall"] = round(time.time() - t0, 2)
        if not basin_checked and 0 < cfg.object_train.N_iters <= h["step"]:
            # one-shot filled-box tripwire at the end of the object phase
            basin_checked.append(True)
            fn = float((trainer.obj_params["sdf_grid"] < 0).float().mean())
            if fn > 0.98:
                print(f"[run] WARNING: probe raw SDF is {fn:.2%} negative at the end of the object phase "
                      "(filled-box basin): mesh extraction will be empty even if pose anchoring works. "
                      "Consider --shell_weight 1.0 --shell_margin 0.05.")
        if args.grid_stats and h["step"] <= cfg.object_train.N_iters + 200:
            raw = trainer.obj_params["sdf_grid"].detach().cpu().numpy()
            h["raw_min"] = round(float(raw.min()), 3)
            h["raw_max"] = round(float(raw.max()), 3)
            h["frac_neg"] = round(float((raw < 0).mean()), 4)
            h["map_alpha"] = round(float(object_sdf.softplus10(trainer.obj_params["sdf_alpha"])), 3)
            h["map_beta"] = round(float(object_sdf.softplus10(trainer.obj_params["sdf_beta"])), 4)
        # pose error against GT after the small-system alignment
        n = trainer.n_active
        aligned_p, _ = align.prealign_w2c_small_camera_systems(trainer.current_pose_host()[:n], poses_gt[:n])
        perr = align.evaluate_camera_alignment(aligned_p, poses_gt[:n])
        h["rot_error"] = float(np.asarray(perr["R"]).mean())
        h["trans_error"] = float(np.asarray(perr["t"]).mean())
        logger.log(h)
        if h["step"] % args.i_print == 0:
            eps = time.time() - t0
            print(f"[{h['step']:6d}/{max_iter}] psnr_scene {h.get('psnr_scene', 0):6.2f} "
                  f"psnr_obj {h.get('psnr_obj', float('nan')):6.2f} loss {h.get('loss_total', 0):8.4f} "
                  f"R {h['rot_error']:5.2f}deg t {h['trans_error']:5.2f} views {h['n_active']} "
                  f"({h['step'] / max(eps, 1e-9):.2f} it/s)")
        if args.i_validate and h["step"] % args.i_validate == 0:
            val = trainer.validate()
            print(f"[val {h['step']}] psnr {val:.2f} (best {trainer.best_val:.2f})")
            if val >= trainer.best_val:
                save("best_ckpt.pkl")
        if args.i_ckpt and h["step"] % args.i_ckpt == 0:
            save("last_ckpt.pkl")
        if args.i_validate_mesh and h["step"] % args.i_validate_mesh == 0 \
                and h["step"] <= cfg.object_train.N_iters:
            om = trainer.cfg.object_model
            vol = object_sdf.extract_sdf_volume(trainer.obj_params, om, resolution=96)
            verts, tris = mesh_mod.extract_mesh_world(vol, om.xyz_min_np, om.xyz_max_np,
                                                      scale_mat=data.scale_mats)
            os.makedirs(os.path.join(out_dir, "meshes"), exist_ok=True)
            mesh_mod.save_ply(os.path.join(out_dir, "meshes", f"deform_{h['step']}.ply"), verts, tris)

    trainer.fit(max_iter, log_every=min(args.i_print, 100), callback=on_log, superstep=max(args.superstep, 1))
    save("last_ckpt.pkl")
    logger.close()
    print(f"[run] training done in {time.time() - t0:.0f}s")

    cur = trainer.current_pose_host()
    aligned, _ = align.prealign_w2c_small_camera_systems(cur, poses_gt)
    err = align.evaluate_camera_alignment(aligned, poses_gt)
    print(f"[run] train-pose error: R {float(err['R'].mean()):.3f} deg, t {float(err['t'].mean()):.4f} (x100)")
    progress = min(trainer.global_step / cfg.scene_model.max_iter, 1.0)

    if args.render_test and len(data.i_test) > 0:
        print("[run] evaluating test split ...")
        results = evaluator.evaluate_full(
            trainer.scene_params, cfg.scene_model, cur, poses_gt, data.images[data.i_test],
            data.poses_gt_w2c[data.i_test], data.Ks[data.i_test], (data.near, data.far),
            test_photo=not args.no_test_optim and cfg.scene_train.test_photo,
            test_iter=cfg.scene_train.test_iter, progress=progress,
            test_depth_gt=None if data.depth_gt is None else data.depth_gt[data.i_test])
        results["train_seconds"] = round(time.time() - t0, 1)
        results["steps"] = int(trainer.global_step)
        print(json.dumps(results, indent=2))
        with open(os.path.join(out_dir, f"{cfg.expname}.json"), "w") as f:
            json.dump(results, f, indent=2)

    if args.render_train:
        # each training view at its optimized pose (no alignment: scene and
        # train poses share the gauge)
        print("[run] rendering training views ...")
        tr_dir = os.path.join(out_dir, "train_renders")
        os.makedirs(tr_dir, exist_ok=True)
        tr_psnrs = []
        for k, v in enumerate(data.i_train[:trainer.n_active]):
            out = evaluator.render_full(trainer.scene_params, cfg.scene_model, cur[k], data.Ks[v], data.H,
                                        data.W, (data.near, data.far), progress=progress)
            gt = torch.as_tensor(np.asarray(data.images[v]), dtype=torch.float32, device=out["rgb"].device)
            tr_psnrs.append(float(metrics_mod.psnr(out["rgb"], gt)))
            write_png(os.path.join(tr_dir, f"train_{k:03d}.png"), validation_panel(
                data.images[v], out["rgb"].cpu().numpy(), out["depth"].cpu().numpy(),
                out["opacity"][..., 0].cpu().numpy()))
        print(f"[run] train-view psnr: mean {np.mean(tr_psnrs):.2f} {['%.2f' % p for p in tr_psnrs]}")

    if args.export_mesh:
        om = trainer.cfg.object_model
        print(f"[run] extracting mesh (marching tetrahedra: {mesh_mod.native_path()}) ...")
        vol = object_sdf.extract_sdf_volume(trainer.obj_params, om, resolution=128)
        verts, tris = mesh_mod.extract_mesh_world(vol, om.xyz_min_np, om.xyz_max_np, scale_mat=data.scale_mats)
        os.makedirs(os.path.join(out_dir, "meshes"), exist_ok=True)
        mesh_mod.save_ply(os.path.join(out_dir, "meshes", "deform_final.ply"), verts, tris)
        print(f"[run] mesh: {len(verts)} vertices, {len(tris)} triangles")

    if args.render_video:
        print("[run] rendering novel-view video ...")
        video_mod.render_video(trainer.scene_params, cfg.scene_model, spiral_w2c(cur, 40),
                               data.Ks[data.i_train[0]], data.H, data.W, (data.near, data.far),
                               os.path.join(out_dir, "spiral_rgb.mp4"),
                               depth_out_path=os.path.join(out_dir, "spiral_depth.mp4"))
    print("[run] all done.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
