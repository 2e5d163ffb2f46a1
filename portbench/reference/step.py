"""The training step of the benchmark's reference: plain PyTorch, float32
outside the MLPs, the MLPs in the precision the configuration states.

A frozen copy of the port's joint step (`train/trainer.py`: `sample_draws`,
`loss`, `object_loss`, `joint_loss`, `_tv_density_loss`, `_step_body`) over
the frozen copies of its plain modules in `port/`. It imports nothing of the
program: the benchmark hands it the inputs it handed the program (the scene's
arrays, the configuration, the weights it made from the seed, the seed of the
step's draws), and it works out again what the program derives from them
(the seeded poses, the mask cache and its chord bound, the optimizer state).

`RefStep(...).step()` runs one step and returns its metrics; `mu_leaves` and
`param_leaves` read the state the benchmark compares.
"""
from __future__ import annotations

import numpy as np
import torch

from .port import config as cfg_mod
from .port.core import pose as pose_ops, rays as rays_mod
from .port.core.graphsafe import take
from .port.core.tree import tree_leaves, tree_unflatten
from .port.losses import (common as loss_common, object as object_losses_mod,
                          projection as projection_losses, scene as scene_losses)
from .port.models import object_sdf, pose_refine, scene_nerf
from .port.ops import grid as grid_ops, maskcache, ray_sampling
from .port.train import batching
from .port.train.optim import ObjectOptimizer, PoseOptimizer, SceneOptimizer


def build_config(exp: dict) -> cfg_mod.ExperimentConfig:
    """The reference's `ExperimentConfig` from the configuration file's
    `experiment` values (lists become tuples, as the dataclasses hold them)."""
    def tup(v):
        return tuple(tup(x) for x in v) if isinstance(v, list) else v

    parts = {"data": cfg_mod.DataConfig, "camera": cfg_mod.CameraConfig, "pnp": cfg_mod.PnPConfig,
             "object_model": object_sdf.ObjectConfig, "object_train": cfg_mod.ObjectTrainConfig,
             "scene_model": scene_nerf.SceneConfig, "scene_train": cfg_mod.SceneTrainConfig}
    kw = {}
    for k, v in exp.items():
        if k in parts:
            kw[k] = parts[k](**{kk: tup(vv) for kk, vv in v.items()})
        else:
            kw[k] = tup(v)
    return cfg_mod.ExperimentConfig(**kw)


def chord_bound(cfg, poses_w2c: np.ndarray, Ks: np.ndarray, H: int, W: int) -> int:
    """The plastic phase's per-ray chord bound K over the given poses."""
    om = cfg.object_model
    return min(om.n_samples, maskcache.max_inbbox_lanes(poses_w2c, Ks, H, W, om.xyz_min_np, om.xyz_max_np,
                                                        om.stepsize * om.voxel_size))


def seeded_poses(cfg, poses_gt: torch.Tensor) -> torch.Tensor:
    """The seeded poses without PnP: GT composed with the configuration's pose
    noise, drawn as the port draws it from `cfg.seed`."""
    init_gen = torch.Generator().manual_seed(cfg.seed)
    scene_nerf.init_scene_params(init_gen, cfg.scene_model, "cpu")      # the draws before the noise, in order
    noise = pose_refine.make_pose_noise(init_gen, poses_gt.shape[0], cfg.camera.noise)
    return pose_ops.compose_pair(noise.to(poses_gt.device), poses_gt)


def _leafify(tree):
    return tree_unflatten(tree, [t.detach().requires_grad_(True) for t in tree_leaves(tree)])


class RefStep:
    """The joint step over the reference's own state.

    `scene`: the arrays of the scene (numpy, as the benchmark made them);
    `params`: {"obj": ..., "scene": ..., "pose": ...} trees of float32
    tensors (copied); `n_active`: the views the step trains on; `draw_seed`:
    the seed of the device generator the step draws from; `fault`: None, or
    "half_batch" (the photometric terms over half the rays)."""

    def __init__(self, cfg, scene: dict, params: dict, n_active: int, draw_seed: int, device,
                 fault: str | None = None):
        self.cfg, self.device, self.fault = cfg, torch.device(device), fault
        ot, sc, sm = cfg.object_train, cfg.scene_train, cfg.scene_model
        if ot.weight_surface_projection > 0 or sc.sample_fraction_in_fg_mask > 0:
            raise ValueError("the reference step has no surface-feature term and no fg-mask sampler")

        def dev(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

        it = np.asarray(scene["i_train"])
        self.images, self.masks = dev(scene["images"][it]), dev(scene["masks"][it])
        self.Ks, self.poses_gt = dev(scene["Ks"][it]), dev(scene["poses_gt_w2c"][it])
        self.scene_matches, self.obj_matches = dev(scene["scene_matches"]), dev(scene["obj_matches"])
        self.pair_j_t = dev(scene["pair_j"], torch.int64)
        self.sampler_pixels = dev(scene["sampler_pixels"], torch.int64)
        self.sampler_counts = dev(scene["sampler_counts"], torch.int64)
        self.H, self.W = self.images.shape[1:3]
        self.near, self.far = float(scene["near"]), float(scene["far"])
        self.inverse_y, self.white_bkgd = bool(scene["inverse_y"]), bool(scene["white_bkgd"])
        self.n_active = n_active
        self.fix_first_pose = bool(cfg.camera.fix_first_pose if cfg.camera.fix_first_pose is not None
                                   else (cfg.pnp.use_pnp or cfg.pnp.use_identical))
        if cfg.pnp.use_pnp or cfg.pnp.use_identical:
            raise ValueError("the reference seeds poses from the configuration's noise only (no PnP)")
        self.poses_pnp = seeded_poses(cfg, self.poses_gt.cpu()).to(self.device)

        self.obj_params = {k: v for k, v in _clone(params["obj"]).items()}
        self.scene_params = _clone(params["scene"])
        self.pose_params = _clone(params["pose"])
        rot_window = int(sc.max_iter * sc.ratio_end_joint_nerf_pose_refinement)
        trans_window = None if sc.ratio_end_pose_trans is None else int(sc.max_iter * sc.ratio_end_pose_trans)
        self.pose_window = max(rot_window, trans_window or 0)
        self.opt_obj, self.opt_scene = ObjectOptimizer(ot), SceneOptimizer(sc)
        self.opt_pose = PoseOptimizer(ot, rot_window, trans_window)
        self.opt_obj_state = self.opt_obj.init(self.obj_params)
        self.opt_scene_state = self.opt_scene.init(self.scene_params)
        self.opt_pose_state = self.opt_pose.init(self.pose_params)
        self.fine_start = (int(sc.max_iter * sm.ratio_start_fine_sampling_at_x)
                           if sm.ratio_start_fine_sampling_at_x is not None else 0)
        self.depth_cons_start = (int(sc.max_iter * sc.start_ratio_depth_cons)
                                 if sc.start_ratio_depth_cons is not None else -1)
        # the plastic phase's mask cache: every voxel on, K the chord bound over GT and the seeded poses
        om = cfg.object_model
        self.mask_arr, self.mask_k = None, None
        if om.use_maskcache:
            poses = np.concatenate([self.poses_gt.cpu().numpy(), self.poses_pnp.cpu().numpy()])
            Ks = np.concatenate([self.Ks.cpu().numpy()] * 2)
            self.mask_k = chord_bound(cfg, poses, Ks, self.H, self.W)
            self.mask_arr = torch.ones(self.obj_params["sdf_grid"].shape[1:], dtype=torch.bool, device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(draw_seed)

    # ---------------------------------------------------------------- flags and draws

    def phase_flags(self, step: int) -> dict:
        cfg, n_iters = self.cfg, self.cfg.object_train.N_iters
        return dict(
            n_active=self.n_active,
            object_on=n_iters > 0 and step <= n_iters,
            pose_on=step < self.pose_window and cfg.object_train.lr_pose > 0,
            fine_on=bool(cfg.scene_model.fine_sampling and step >= self.fine_start),
            depth_cons_on=bool(self.depth_cons_start >= 0 and step >= self.depth_cons_start),
            precrop_on=step < cfg.scene_train.precrop_iters,
            proj_use_deform=step <= n_iters and self.n_active > 2,
        )

    def sample_draws(self, flags: dict) -> dict:
        sc, sm = self.cfg.scene_train, self.cfg.scene_model
        n_active, g, d = flags["n_active"], self.generator, self.device
        pixels = batching.draw_scene_pixels(
            g, n_active, sm.rand_rays // n_active, self.H, self.W, sc.depth_regu_patch_size,
            precrop=flags["precrop_on"], precrop_frac=sc.precrop_frac,
            center_fraction=sc.sampled_fraction_in_center, has_fg=False, n_fg_patches=0, device=d)
        n_pix = sum(pixels[k].shape[-1] for k in ("x", "cx", "fg_u")) * sc.depth_regu_patch_size ** 2
        M = self.scene_matches.shape[1]
        draws = {"pixels": pixels,
                 "corres_view": torch.randint(0, n_active, (), generator=g, device=d),
                 "render": ray_sampling.draw_render_noise(g, 1, n_active * n_pix + 2 * M, sm.sample_intvs,
                                                          sm.sample_intvs_fine, d)}
        if flags["depth_cons_on"]:
            draws["dc_interp_w"] = torch.rand((), generator=g, device=d)
            if sc.loss_weight_dict().get("corres") is None:
                raise ValueError("the reference step renders depth consistency from the corres pair only")
            draws["dc_render"] = ray_sampling.draw_render_noise(g, 1, M, sm.sample_intvs, sm.sample_intvs_fine, d)
        if flags["object_on"]:
            ot = self.cfg.object_train
            draws["object"] = batching.draw_object_batch(g, ot.N_rand, n_active, d)
            draws["object_jitter"] = torch.rand((ot.N_rand, 1), generator=g, device=d)
            draws["proj_view"] = torch.randint(0, n_active, (), generator=g, device=d)
        return draws

    # ---------------------------------------------------------------- losses

    def _half(self, x: torch.Tensor, dim: int, unit: int = 1) -> torch.Tensor:
        """The fault "half_batch": the first half of the rays along `dim`, in whole groups of `unit`."""
        return x.narrow(dim, 0, x.shape[dim] // 2 // unit * unit) if self.fault == "half_batch" else x

    def scene_loss(self, scene_p, pose_p, step, flags, draws):
        cfg = self.cfg
        sc, sm = cfg.scene_train, cfg.scene_model
        n_active = flags["n_active"]
        progress = torch.clamp(step / sm.max_iter, 0.0, 1.0)
        depth_range = (self.near, self.far)
        current_pose = pose_refine.current_pose_pnp(pose_p, self.poses_pnp, fix_first=self.fix_first_pose)
        if not flags["pose_on"]:
            current_pose = current_pose.detach()
        active_pose, active_K = current_pose[:n_active], self.Ks[:n_active]
        scene_pc = scene_nerf.cast_mlp_params(scene_p, sm.matmul_dtype)
        sbatch = batching.sample_scene_pixels(
            draws["pixels"], n_active, self.H, self.W, sc.depth_regu_patch_size, self.images[:n_active],
            n_active, precrop=flags["precrop_on"], precrop_frac=sc.precrop_frac, fg_pixels=None, fg_counts=None)
        center_m, ray_m = rays_mod.get_center_and_ray_at_pixels(active_pose, sbatch.pixels, active_K)
        R_v = center_m.shape[1]
        R_main = n_active * R_v
        lw = sc.loss_weight_dict()
        use_corres = lw.get("corres") is not None
        use_dc = flags["depth_cons_on"] and lw.get("depth_cons") is not None
        center_all, ray_all = center_m.reshape(1, R_main, 3), ray_m.reshape(1, R_main, 3)
        if use_corres:
            r = draws["corres_view"]
            pack = take(self.scene_matches, r)
            px_self, px_other, conf = pack[:, 2:4], pack[:, 0:2], pack[:, 4]
            id_self, id_other = r, take(self.pair_j_t, r)
            center_c, ray_c = scene_losses.correspondence_pair_rays(current_pose, self.Ks, px_self, px_other,
                                                                    id_self, id_other)
            M = center_c.shape[1]
            center_all = torch.cat([center_all, center_c.reshape(1, 2 * M, 3)], dim=1)
            ray_all = torch.cat([ray_all, ray_c.reshape(1, 2 * M, 3)], dim=1)
        R_all = center_all.shape[1]
        noise = dict(draws["render"], jitter=draws["render"]["jitter"][:, :R_all])
        rets_all = scene_nerf.render_rays(scene_pc, sm, center_all, ray_all, depth_range, progress, noise=noise,
                                          compute_fine=flags["fine_on"])
        rets_all = {k: v for k, v in rets_all.items() if k not in ("origins", "viewdirs")}
        rets = {k: v[:, :R_main].reshape((n_active, R_v) + v.shape[2:]) for k, v in rets_all.items()}
        target = sbatch.target
        if self.fault == "half_batch":
            p2 = sc.depth_regu_patch_size ** 2
            rets = {k: self._half(v, 1, p2) for k, v in rets.items()}
            target = self._half(target, 1, p2)
        loss_dict = dict(scene_losses.photometric_and_regu_loss(rets, target, sc))
        if use_corres:
            depth_pair = rets_all["depth"][0, R_main:, 0].reshape(2, M)
            depth_fine_pair = (rets_all["depth_fine"][0, R_main:, 0].reshape(2, M)
                               if "depth_fine" in rets_all else None)
            loss_dict["corres"] = scene_losses.correspondence_loss_from_depths(
                depth_pair, depth_fine_pair, current_pose, self.Ks, px_self, px_other, conf, id_self, id_other,
                step, sc)
        if use_dc:
            d_ref = depth_fine_pair[0] if depth_fine_pair is not None else depth_pair[0]
            loss_dict["depth_cons"] = scene_losses.depth_consistency_from_ref_depth(
                scene_pc, sm, active_pose, active_K, px_self, d_ref, id_self, interp_w=draws["dc_interp_w"],
                H=self.H, W=self.W, depth_range=depth_range, progress=progress, iteration=step,
                compute_fine=flags["fine_on"], opt=sc, noise=draws["dc_render"], ref_valid=conf > 0)
        total = loss_common.summarize_losses(loss_dict, lw)
        return total, {"loss_render": loss_dict["render"], "loss_total": total}

    def object_loss(self, obj_p, pose_p, step, flags, draws):
        cfg = self.cfg
        oc, ot = cfg.object_model, cfg.object_train
        step_f = step.to(torch.float32)
        current_pose = pose_refine.current_pose_pnp(pose_p, self.poses_pnp, fix_first=self.fix_first_pose)
        if not flags["pose_on"]:
            current_pose = current_pose.detach()
        batch = batching.sample_object_batch(draws["object"], self.images, self.masks, self.Ks, current_pose,
                                             self.sampler_pixels, self.sampler_counts, self.inverse_y)
        render_out = object_sdf.render(
            obj_p, oc, batch.rays_o, batch.rays_d, batch.viewdirs, global_step=step_f,
            jitter=draws["object_jitter"], use_deform=True, is_train=True, near=self.near, far=self.far,
            bg=1.0 if self.white_bkgd else 0.0, mask_grid=self.mask_arr, mask_k=self.mask_k)
        target, mask = batch.target, batch.mask
        if self.fault == "half_batch":
            render_out = {k: (self._half(v, 0) if torch.is_tensor(v) and v.dim() > 0
                              and v.shape[0] == target.shape[0] else v) for k, v in render_out.items()}
            target, mask = self._half(target, 0), self._half(mask, 0)
        k0_tv = object_losses_mod.k0_total_variation(obj_p)
        _, _, obj_loss, _ = object_losses_mod.object_losses(
            render_out, target, mask, step_f, oc.N_iters, weight_main=ot.weight_main,
            weight_mask=ot.weight_mask, weight_tv_k0=ot.weight_tv_k0, k0_tv_value=k0_tv, use_deform=True,
            deform_prior_init=ot.weight_deform_prior_init, deform_prior_final=ot.weight_deform_prior_final)
        obj_loss = obj_loss + self._tv_density_loss(obj_p, step)
        if ot.weight_shell > 0:
            obj_loss = obj_loss + ot.weight_shell * object_losses_mod.shell_positivity_loss(
                obj_p["sdf_grid"], ot.shell_margin)
        if ot.projection_dis_error > 0:
            r = draws["proj_view"]
            pack = take(self.obj_matches, r)
            proj_err, near_surf = projection_losses.projection_error_loss(
                obj_p, oc, current_pose, self.Ks, coord_self=pack[:, 0:2], coord_other=pack[:, 2:4],
                mconf=pack[:, 4], id_i=take(self.pair_j_t, r), id_j=r, global_step=step_f,
                inverse_y=self.inverse_y, use_deform=flags["proj_use_deform"], pixel_thre=200.0,
                near=self.near, far=self.far, mask_grid=self.mask_arr, mask_k=self.mask_k)
            obj_loss = obj_loss + ot.projection_dis_error * proj_err + ot.weight_near_surface * near_surf
        return obj_loss

    def _tv_density_loss(self, obj_p, step):
        ot, oc = self.cfg.object_train, self.cfg.object_model
        if ot.weight_tv_density <= 0:
            return 0.0
        sdf_tv = torch.full_like(step, ot.sdf_tv, dtype=torch.float32)
        smooth_tv = torch.full_like(step, ot.smooth_grad_tv, dtype=torch.float32)
        for ev_step, updates in ot.tv_updates:
            upd = dict(updates)
            if "sdf_tv" in upd:
                sdf_tv = torch.where(step >= ev_step, upd["sdf_tv"], sdf_tv)
            if "smooth_grad_tv" in upd:
                smooth_tv = torch.where(step >= ev_step, upd["smooth_grad_tv"], smooth_tv)
        total = 0.0
        if ot.sdf_tv > 0:
            total = total + grid_ops.total_variation(obj_p["sdf_grid"]) / 2.0 / oc.voxel_size * sdf_tv
        if ot.smooth_grad_tv > 0:
            grad = grid_ops.sdf_gradient_grid(obj_p["sdf_grid"], oc.voxel_size)
            kernel = object_losses_mod._tv_smooth_kernel(self.device)
            total = total + grid_ops.smooth_grad_tv(grad, kernel) * smooth_tv
        return ot.weight_tv_density * total

    # ---------------------------------------------------------------- the step

    def groups(self, flags: dict) -> list:
        return (["obj"] if flags["object_on"] else []) + ["scene"] + (["pose"] if flags["pose_on"] else [])

    def step(self, step: int) -> dict:
        """One step at step number `step`: draws, loss, one backward pass and
        the optimizers' updates. Returns {"loss_total": float}."""
        flags = self.phase_flags(step)
        draws = self.sample_draws(flags)
        names = self.groups(flags)
        params = {n: getattr(self, f"{n}_params") for n in ("obj", "scene", "pose")}
        params.update({n: _leafify(params[n]) for n in names})
        step_t = torch.full((), step, dtype=torch.int64, device=self.device)
        total, metrics = self.scene_loss(params["scene"], params["pose"], step_t, flags, draws)
        if flags["object_on"]:
            total = total + 0.1 * self.object_loss(params["obj"], params["pose"], step_t, flags, draws)
        leaves = [tree_leaves(params[n]) for n in names]
        flat = [x for group in leaves for x in group]
        grads = torch.autograd.grad(total, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
        start = 0
        with torch.no_grad():
            for n, group in zip(names, leaves):
                own = getattr(self, f"{n}_params")
                g = tree_unflatten(own, grads[start:start + len(group)])
                start += len(group)
                up, state = getattr(self, f"opt_{n}").update(g, getattr(self, f"opt_{n}_state"))
                setattr(self, f"opt_{n}_state", state)
                torch._foreach_add_(tree_leaves(own), tree_leaves(up))
        return {"loss_total": float(total.detach())}


def _clone(tree):
    return tree_unflatten(tree, [t.detach().clone().float() for t in tree_leaves(tree)])
