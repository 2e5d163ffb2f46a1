"""Evaluation CLI of the PyTorch port: the counterpart of the repository's `eval.py`.

    python -m poseprobe_tpu_torch.evaluate --config <preset.py> --datadir <path> \
        --ckpt logs/<exp>/last_ckpt.pkl [--render_video] [--eval_mesh [--gt_stl stl_total.ply]]
    python -m poseprobe_tpu_torch.evaluate --synthetic --ckpt logs/synthetic/last_ckpt.pkl --eval_mesh

Takes every flag of `eval.py` under the same name and does its steps:
restore a checkpoint written by either package, align the optimized poses to
GT, evaluate the test views with and without test-time pose optimization
(`w_test_optim` / `without_test_optim`), and optionally extract the object
mesh from a 256^3 volume, drop its small components and score it: against a
DTU scan (`--gt_stl`) or, for the synthetic scene, against its analytic probe
surface with the symmetric observation culls (`chamfer.json`; an empty mesh
writes a failure record there). `--render_video` renders the 60-frame spiral.
The feature grid's backend (dense or TensoRF) is the checkpoint's.
(`eval/` is a package of the port, hence the module's name.) It runs on the
card and raises without one, unless `--cpu` asks for the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np

from . import run as run_mod
from .core import align
from .data import synthetic as synth_mod
from .data.loaders import load_data
from .eval import dtu_protocol, evaluator, mesh as mesh_mod, video as video_mod
from .models import object_sdf
from .train import state as state_mod
from .train.trainer import JointTrainer


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate a PoseProbe checkpoint with the PyTorch port.")
    p.add_argument("--config", type=str, default="")
    p.add_argument("--datadir", type=str, default="")
    p.add_argument("--scene", type=str, default="",
                   help="scene/scan selector for family presets (see run)")
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--out_dir", type=str, default="")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--probe", type=str, default="cube", choices=["cube", "sphere"],
                   help="synthetic scene: probe shape (must match the run)")
    p.add_argument("--n_views", type=int, default=0,
                   help="synthetic-only: number of training views the ckpt was trained with")
    p.add_argument("--n_test", type=int, default=0,
                   help="synthetic-only: held-out view count (must match the run)")
    p.add_argument("--res", type=int, default=0, help="synthetic-only: image H=W (must match the run)")
    p.add_argument("--texture", type=str, default="checker", choices=["checker", "noise"],
                   help="synthetic-only: surface texture (must match the run)")
    p.add_argument("--no_test_optim", action="store_true")
    p.add_argument("--render_video", action="store_true")
    p.add_argument("--eval_mesh", action="store_true")
    p.add_argument("--mesh_only", action="store_true",
                   help="skip the NVS/pose eval; just extract + score the mesh")
    p.add_argument("--cpu", action="store_true", help="run on the CPU; without it the evaluation needs a CUDA card")
    p.add_argument("--gt_stl", type=str, default="")
    p.add_argument("--matcher", type=str, default="auto")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = run_mod.resolve_device(args.cpu)
    cfg = run_mod.load_config(args)
    payload = state_mod.load_checkpoint(args.ckpt)
    cfg = dataclasses.replace(cfg, object_model=dataclasses.replace(
        cfg.object_model, grid_type=state_mod.grid_type(payload)))
    data = load_data(cfg.data, matcher_backend=args.matcher, matcher_device=device,
                     **run_mod.synthetic_loader_kwargs(cfg, args, run=False))
    trainer = JointTrainer(cfg, data, device=device)
    state_mod.restore_state(trainer, payload)
    print(f"[eval] restored step {trainer.global_step} from {args.ckpt} on {device}")
    out_dir = args.out_dir or os.path.join(cfg.basedir, cfg.expname, "eval")
    os.makedirs(out_dir, exist_ok=True)
    cur = trainer.current_pose_host()
    poses_gt = data.poses_gt_w2c[data.i_train]

    def run_one(test_optim: bool, save: bool):
        return evaluator.evaluate_full(
            trainer.scene_params, cfg.scene_model, cur, poses_gt, data.images[data.i_test],
            data.poses_gt_w2c[data.i_test], data.Ks[data.i_test], (data.near, data.far),
            test_photo=test_optim, test_iter=cfg.scene_train.test_iter,
            save_dir=os.path.join(out_dir, "test_renders") if save else None,
            progress=min(trainer.global_step / cfg.scene_model.max_iter, 1.0),
            test_depth_gt=None if data.depth_gt is None else data.depth_gt[data.i_test])

    if not args.mesh_only:
        results = {"iteration": trainer.global_step}
        if not args.no_test_optim and cfg.scene_train.test_photo:
            results["w_test_optim"] = run_one(True, save=True)
            results["without_test_optim"] = run_one(False, save=False)
        else:
            results.update(run_one(False, save=True))
        print(json.dumps(results, indent=2))
        with open(os.path.join(out_dir, f"{cfg.expname}.json"), "w") as f:
            json.dump(results, f, indent=2)

    if args.eval_mesh or args.mesh_only:
        om = trainer.cfg.object_model
        print(f"[eval] extracting the mesh (marching tetrahedra: {mesh_mod.native_path()}) ...")
        vol = object_sdf.extract_sdf_volume(trainer.obj_params, om, resolution=256)
        verts, tris = mesh_mod.extract_mesh_world(vol, om.xyz_min_np, om.xyz_max_np, scale_mat=data.scale_mats)
        comp_info = {}
        if len(verts):
            # drop the salt-noise shells of the noisy far-field SDF (the kept
            # fraction goes into chamfer.json)
            verts, tris, comp_info = mesh_mod.filter_small_components(verts, tris)
            print(f"[eval] component filter: {comp_info}")
        if len(verts) == 0:
            # no zero crossing inside the box: score it as a failure
            diag = {"error": "empty mesh", "vol_min": float(vol.min()), "vol_max": float(vol.max()),
                    "vol_frac_inside": float((vol > 0).mean())}
            print("[eval] mesh extraction empty:", diag)
            with open(os.path.join(out_dir, "chamfer.json"), "w") as f:
                json.dump(diag, f, indent=2)
        else:
            mesh_mod.save_ply(os.path.join(out_dir, "mesh.ply"), verts, tris)
            print(f"[eval] mesh: {len(verts)} vertices, {len(tris)} triangles")
            chamfer = None
            if args.gt_stl and os.path.exists(args.gt_stl):
                chamfer = dtu_protocol.evaluate_mesh_dtu(verts, tris, dtu_protocol.load_stl_points(args.gt_stl))
                print("[eval] chamfer:", chamfer)
            elif cfg.data.dataset_type == "synthetic":
                chamfer = _synthetic_chamfer(verts, tris, cur, data, args.probe)
                chamfer.update({f"mesh_{k}": v for k, v in comp_info.items()})
                print("[eval] synthetic GT chamfer (world units):", chamfer)
            if chamfer is not None:
                with open(os.path.join(out_dir, "chamfer.json"), "w") as f:
                    json.dump(chamfer, f, indent=2)

    if args.render_video:
        video_mod.render_video(trainer.scene_params, cfg.scene_model, run_mod.spiral_w2c(cur, 60),
                               data.Ks[data.i_train[0]], data.H, data.W, (data.near, data.far),
                               os.path.join(out_dir, "spiral_rgb.mp4"),
                               depth_out_path=os.path.join(out_dir, "spiral_depth.mp4"))
    print("[eval] done.")
    return 0


def _synthetic_chamfer(verts, tris, cur, data, probe: str) -> dict:
    """The synthetic scene's geometry protocol: the mesh, carried from the
    trained gauge into GT units by the sim3 that aligns the train poses,
    scored against the analytic probe surface within its box + 0.15, both
    sets culled by the same criterion (the visual hull of the train views and,
    with GT depth, their observed space)."""
    tr = data.i_train
    _, sim3 = align.prealign_w2c_small_camera_systems(cur, data.poses_gt_w2c[tr])
    verts_gt = align.apply_sim3_points(verts, sim3)
    gt_pts = synth_mod.probe_surface_points(probe=probe)
    pad = 0.15
    bbox = np.stack([gt_pts.min(0) - pad, gt_pts.max(0) + pad])

    def cull(p):
        keep = dtu_protocol.visual_hull_cull(p, data.masks[tr], data.poses_gt_w2c[tr], data.Ks[tr])
        if data.depth_gt is not None:
            # tol 0.1: at 3 views a tighter tolerance culls real surface seen only at grazing angles
            keep &= dtu_protocol.observed_space_cull(p, data.depth_gt[tr], data.poses_gt_w2c[tr], data.Ks[tr],
                                                     tol=0.1)
        return keep

    chamfer = dtu_protocol.evaluate_mesh_dtu(verts_gt, tris, gt_pts, bbox=bbox, max_dist=0.5, pred_cull=cull,
                                             gt_cull=cull if data.depth_gt is not None else None)
    chamfer["sim3_scale"] = sim3.s
    return chamfer


if __name__ == "__main__":
    raise SystemExit(main())
