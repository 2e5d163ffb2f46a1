"""The joint training step: the early, coarse and mid phase programs.

Port of `poseprobe_tpu/train/trainer.py`'s `JointTrainer`.

`SceneTrainer` is the step with the object branch off (`object_on=False`,
the coarse and mid phases): it renders the main rays and the correspondence
pair rays in a single batched `render_rays` call, adds the correspondence
and (mid phase) depth consistency losses, takes one backward pass and
updates the scene params and, while the pose window is open, the poses.

`JointTrainer` extends it with the object branch (the early phase, steps up
to `object_train.N_iters`): the semantic ray batch, the SDF render through
the deformation field, the object losses, the k0 and SDF total-variation
terms, the shell prior and the match-reprojection term, mixed as
``0.1 * object_loss + scene_loss``, one backward pass and a third optimizer;
plus the mask cache (`refresh_maskcache`) and progressive grid scaling
(`scale_volume_grid`, `maybe_pg_scale`).

Randomness is injected: `step(draws)` takes every random number of the step
as tensors (`sample_draws` makes them from the trainer's generators when the
caller passes none), so a test can feed this step and the JAX step the same
numbers. `fit` is a plain loop over steps with the grid-scaling and
mask-cache cadence.

Not ported yet, and raising `NotImplementedError` where a config asks for
them: PnP pose initialisation (`pnp.use_pnp` / `use_identical`), depth
consistency from fresh pixels (the corres term off), the TensoRF feature grid,
`use_pallas_composite`, and the surface-feature loss
(`weight_surface_projection > 0`). The host pose events (view activation,
warmup, rescue, BA polish, probe health, the plastic chord-K re-bound) and the
`lax.scan` supersteps are later slices.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config.config import ExperimentConfig
from ..core import pose as pose_ops, rays as rays_mod
from ..core.tree import tree_leaves, tree_unflatten
from ..data.base import SceneData
from ..losses import (common as loss_common, object as object_losses_mod,
                      projection as projection_losses, scene as scene_losses)
from ..models import object_sdf, pose_refine, scene_nerf
from ..ops import compositing, grid as grid_ops, maskcache, ray_sampling
from . import batching
from .optim import ObjectOptimizer, PoseOptimizer, SceneOptimizer

# bench.py's workload constants (the 60k-step schedule at reference scale)
N_ITERS = 10000
MAX_ITER = 60000
FINE_START_RATIO = 0.3


class SceneTrainer:
    """Owns the device data, scene/pose params, optimizer states and the step."""

    GROUPS = ("scene", "pose")

    def __init__(self, cfg: ExperimentConfig, data: SceneData, seed: int | None = None,
                 device="cuda"):
        if cfg.pnp.use_pnp or cfg.pnp.use_identical:
            raise NotImplementedError("PnP pose initialisation is not ported yet: "
                                      "use PnPConfig(use_pnp=False) (noisy-GT init)")
        self.cfg, self.data = cfg, data
        self.device = torch.device(device)
        seed = cfg.seed if seed is None else seed
        init_gen = torch.Generator().manual_seed(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.host_generator = torch.Generator().manual_seed(seed + 2)

        def dev(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

        it = data.i_train
        self.images = dev(data.images[it])
        self.Ks = dev(data.Ks[it])
        self.poses_gt = dev(data.poses_gt_w2c[it])
        self.scene_matches = dev(data.scene_matches)
        self.pair_j = np.asarray(data.pair_j)
        self.n_train = data.n_train
        self.H, self.W = data.H, data.W

        sc, sm = cfg.scene_train, cfg.scene_model
        self.fg_pixels = self.fg_counts = None
        self._n_fg_patches = 0
        if sc.sample_fraction_in_fg_mask > 0:
            pools, counts = batching.dilate_fg_mask_pools(data.masks[it], sc.depth_regu_patch_size)
            self.fg_pixels = dev(pools, torch.int64)
            self.fg_counts = dev(counts, torch.int64)
            n_patches = max(sm.rand_rays // self.n_train // sc.depth_regu_patch_size ** 2, 1)
            self._n_fg_patches = min(int(n_patches * sc.sample_fraction_in_fg_mask),
                                     int(counts.min()))

        self.scene_params = scene_nerf.init_scene_params(init_gen, sm, self.device)
        self.pose_params = pose_refine.init_pose_params(self.n_train, self.device)
        pose_noise = pose_refine.make_pose_noise(init_gen, self.n_train, cfg.camera.noise)
        self.poses_pnp = pose_ops.compose_pair(pose_noise.to(self.device), self.poses_gt)

        rot_window = int(sc.max_iter * sc.ratio_end_joint_nerf_pose_refinement)
        trans_window = (None if sc.ratio_end_pose_trans is None
                        else int(sc.max_iter * sc.ratio_end_pose_trans))
        self.pose_window = max(rot_window, trans_window or 0)
        self.opt_scene = SceneOptimizer(sc)
        self.opt_pose = PoseOptimizer(cfg.object_train, rot_window, trans_window)
        self.opt_scene_state = self.opt_scene.init(self.scene_params)
        self.opt_pose_state = self.opt_pose.init(self.pose_params)

        self.global_step = 0
        self.n_active = 2 if (cfg.camera.incremental and self.n_train > 2) else self.n_train
        self.fine_start = (int(sc.max_iter * sm.ratio_start_fine_sampling_at_x)
                           if sm.ratio_start_fine_sampling_at_x is not None else 0)
        self.depth_cons_start = (int(sc.max_iter * sc.start_ratio_depth_cons)
                                 if sc.start_ratio_depth_cons is not None else -1)

    @property
    def fix_first_pose(self) -> bool:
        if self.cfg.camera.fix_first_pose is not None:
            return bool(self.cfg.camera.fix_first_pose)
        return bool(self.cfg.pnp.use_pnp or self.cfg.pnp.use_identical)

    def phase_flags(self, step: int) -> dict:
        cfg = self.cfg
        return dict(
            n_active=self.n_active,
            object_on=False,
            pose_on=step < self.pose_window and cfg.object_train.lr_pose > 0,
            fine_on=bool(cfg.scene_model.fine_sampling and step >= self.fine_start),
            depth_cons_on=bool(self.depth_cons_start >= 0 and step >= self.depth_cons_start),
            precrop_on=step < cfg.scene_train.precrop_iters,
        )

    def sample_draws(self, flags: dict) -> dict:
        """Every random number of one step, from the trainer's generators."""
        sc, sm = self.cfg.scene_train, self.cfg.scene_model
        n_active = flags["n_active"]
        pixels = batching.draw_scene_pixels(
            self.generator, n_active, sm.rand_rays // n_active, self.H, self.W,
            sc.depth_regu_patch_size, precrop=flags["precrop_on"], precrop_frac=sc.precrop_frac,
            center_fraction=sc.sampled_fraction_in_center, has_fg=self.fg_pixels is not None,
            n_fg_patches=self._n_fg_patches, device=self.device)
        n_pix = sum(pixels[k].shape[-1] for k in ("x", "cx", "fg_u")) * sc.depth_regu_patch_size ** 2
        M = self.scene_matches.shape[1]
        n_rays = n_active * n_pix + 2 * M
        draws = {
            "pixels": pixels,
            "corres_view": int(torch.randint(0, n_active, (), generator=self.host_generator)),
            "render": ray_sampling.draw_render_noise(self.generator, 1, n_rays, sm.sample_intvs,
                                                     sm.sample_intvs_fine, self.device),
        }
        if flags["depth_cons_on"]:
            draws["dc_interp_w"] = torch.rand((), generator=self.generator, device=self.device)
            draws["dc_render"] = ray_sampling.draw_render_noise(
                self.generator, 1, M, sm.sample_intvs, sm.sample_intvs_fine, self.device)
        return draws

    def loss(self, scene_p: dict, pose_p: dict, step: int, flags: dict, draws: dict):
        """Total scene loss and metrics of one step (the scene half of the
        reference's `_step_impl.loss_fn`)."""
        cfg = self.cfg
        sc, sm = cfg.scene_train, cfg.scene_model
        n_active = flags["n_active"]
        progress = torch.clamp(torch.tensor(step, dtype=torch.float32, device=self.device)
                               / sm.max_iter, 0.0, 1.0)
        depth_range = (self.data.near, self.data.far)

        current_pose = pose_refine.current_pose_pnp(pose_p, self.poses_pnp,
                                                    fix_first=self.fix_first_pose)
        if not flags["pose_on"]:
            # pose window closed: no pose update, so no gradient into the poses
            current_pose = current_pose.detach()
        active_pose, active_K = current_pose[:n_active], self.Ks[:n_active]
        scene_pc = scene_nerf.cast_mlp_params(scene_p, sm.matmul_dtype)
        sbatch = batching.sample_scene_pixels(
            draws["pixels"], n_active, self.H, self.W, sc.depth_regu_patch_size,
            self.images[:n_active], n_active, precrop=flags["precrop_on"],
            precrop_frac=sc.precrop_frac,
            fg_pixels=None if self.fg_pixels is None else self.fg_pixels[:n_active],
            fg_counts=None if self.fg_counts is None else self.fg_counts[:n_active])
        center_m, ray_m = rays_mod.get_center_and_ray_at_pixels(active_pose, sbatch.pixels,
                                                                active_K)
        R_v = center_m.shape[1]
        R_main = n_active * R_v

        lw = sc.loss_weight_dict()
        use_corres = lw.get("corres") is not None
        use_dc = flags["depth_cons_on"] and lw.get("depth_cons") is not None

        # the main rays and the corres pair rays go through ONE render call
        center_all = center_m.reshape(1, R_main, 3)
        ray_all = ray_m.reshape(1, R_main, 3)
        if use_corres:
            r = draws["corres_view"]
            pack = self.scene_matches[r]
            px_self, px_other, conf = pack[:, 2:4], pack[:, 0:2], pack[:, 4]
            id_self, id_other = r, int(self.pair_j[r])
            center_c, ray_c = scene_losses.correspondence_pair_rays(
                current_pose, self.Ks, px_self, px_other, id_self, id_other)
            M = center_c.shape[1]
            center_all = torch.cat([center_all, center_c.reshape(1, 2 * M, 3)], dim=1)
            ray_all = torch.cat([ray_all, ray_c.reshape(1, 2 * M, 3)], dim=1)
        noise = dict(draws["render"], jitter=draws["render"]["jitter"][:, :center_all.shape[1]])
        rets_all = scene_nerf.render_rays(scene_pc, sm, center_all, ray_all, depth_range,
                                          progress, noise=noise, compute_fine=flags["fine_on"])

        rets = {k: v[:, :R_main].reshape((n_active, R_v) + v.shape[2:])
                for k, v in rets_all.items() if k not in ("origins", "viewdirs")}
        loss_dict = dict(scene_losses.photometric_and_regu_loss(rets, sbatch.target, sc))
        if use_corres:
            depth_pair = rets_all["depth"][0, R_main:, 0].reshape(2, M)
            depth_fine_pair = (rets_all["depth_fine"][0, R_main:, 0].reshape(2, M)
                               if "depth_fine" in rets_all else None)
            loss_dict["corres"] = scene_losses.correspondence_loss_from_depths(
                depth_pair, depth_fine_pair, current_pose, self.Ks, px_self, px_other, conf,
                id_self, id_other, step, sc)
        if use_dc:
            if not use_corres:
                raise NotImplementedError("depth consistency without the corres term (fresh "
                                          "reference pixels) is not ported yet")
            d_ref = depth_fine_pair[0] if depth_fine_pair is not None else depth_pair[0]
            loss_dict["depth_cons"] = scene_losses.depth_consistency_from_ref_depth(
                scene_pc, sm, active_pose, active_K, px_self, d_ref, id_self,
                interp_w=draws["dc_interp_w"], H=self.H, W=self.W, depth_range=depth_range,
                progress=progress, iteration=step, compute_fine=flags["fine_on"], opt=sc,
                noise=draws["dc_render"], ref_valid=conf > 0)
        total = loss_common.summarize_losses(loss_dict, lw)
        mse = ((rets["rgb"] - sbatch.target) ** 2).mean()
        metrics = {"psnr_scene": loss_common.mse2psnr(mse), "loss_render": loss_dict["render"]}
        if "corres" in loss_dict:
            metrics["loss_corres"] = loss_dict["corres"]
        metrics["loss_total"] = total
        return total, metrics

    def _trained(self, flags: dict) -> list:
        """Names of the param groups this step updates."""
        return ["scene"] + (["pose"] if flags["pose_on"] else [])

    def _loss(self, params: dict, step: int, flags: dict, draws: dict):
        return self.loss(params["scene"], params["pose"], step, flags, draws)

    def step(self, draws: dict | None = None) -> dict:
        """One training step; returns its metrics (0-dim tensors on the device)."""
        flags = self.phase_flags(self.global_step)
        if draws is None:
            draws = self.sample_draws(flags)
        names = self._trained(flags)
        params = {n: getattr(self, f"{n}_params") for n in self.GROUPS}
        params.update({n: _leafify(params[n]) for n in names})
        total, metrics = self._loss(params, self.global_step, flags, draws)

        leaves = [tree_leaves(params[n]) for n in names]
        flat = [x for group in leaves for x in group]
        grads = torch.autograd.grad(total, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
        start = 0
        for n, group in zip(names, leaves):
            old = getattr(self, f"{n}_params")
            g = tree_unflatten(old, grads[start:start + len(group)])
            start += len(group)
            up, new_state = getattr(self, f"opt_{n}").update(g, getattr(self, f"opt_{n}_state"))
            setattr(self, f"opt_{n}_state", new_state)
            setattr(self, f"{n}_params", _add(old, up))
        self.global_step += 1
        return {k: v.detach() for k, v in metrics.items()}

    def fit(self, num_steps: int) -> list:
        return [self.step() for _ in range(num_steps)]


class JointTrainer(SceneTrainer):
    """`SceneTrainer` plus the object branch: the full joint step."""

    GROUPS = ("obj", "scene", "pose")

    def __init__(self, cfg: ExperimentConfig, data: SceneData, seed: int | None = None,
                 device="cuda"):
        ot = cfg.object_train
        if ot.weight_surface_projection > 0:
            raise NotImplementedError("weight_surface_projection > 0: the surface-feature loss needs "
                                      "the VGG feature maps of the evaluation slice (ROADMAP.md, "
                                      "modules to port, item 3)")
        # progressive scaling: start at num_voxels / 2^len(pg_scale) and double
        # the voxel count at each checkpoint step
        self._pg_scale = tuple(ot.pg_scale)
        self._final_num_voxels = cfg.object_model.num_voxels
        if self._pg_scale:
            shrunk = int(cfg.object_model.num_voxels / (2 ** len(self._pg_scale)))
            cfg = dataclasses.replace(cfg, object_model=dataclasses.replace(
                cfg.object_model, num_voxels=shrunk))
        super().__init__(cfg, data, seed=seed, device=device)
        seed = cfg.seed if seed is None else seed
        dev = lambda a, dtype=torch.float32: torch.as_tensor(  # noqa: E731
            np.asarray(a), dtype=dtype, device=self.device)
        it = data.i_train
        self.masks = dev(data.masks[it])
        self.sampler_pixels = dev(data.samplers.pixels, torch.int64)
        self.sampler_counts = dev(data.samplers.counts, torch.int64)
        self.obj_matches = dev(data.obj_matches)

        om = cfg.object_model
        obj_params = object_sdf.init_object_params(torch.Generator().manual_seed(seed + 3), om,
                                                   self.device)
        cam_centers = pose_ops.invert(self.poses_gt)[:, :3, 3].cpu().numpy()
        self.obj_params = object_sdf.maskout_near_cam_vox(obj_params, om, cam_centers, data.near)
        self.opt_obj = ObjectOptimizer(ot)
        self.opt_obj_state = self.opt_obj.init(self.obj_params)

        # Free-space-skipping occupancy cache. _k_phase: the tight per-ray
        # chord bound of the plastic-phase compaction, over the GT and the
        # seeded poses so pose drift stays inside the margin.
        self.mask_arr = None
        self._mask_k = None
        self._k_phase = None
        if om.use_maskcache:
            all_poses = np.concatenate([self.poses_gt.cpu().numpy(), self.poses_pnp.cpu().numpy()])
            all_Ks = np.concatenate([self.Ks.cpu().numpy()] * 2)
            self._k_phase = min(om.n_samples, maskcache.max_inbbox_lanes(
                all_poses, all_Ks, self.H, self.W, om.xyz_min_np, om.xyz_max_np,
                om.stepsize * om.voxel_size))
            self.refresh_maskcache()

    def phase_flags(self, step: int) -> dict:
        n_iters = self.cfg.object_train.N_iters
        return dict(super().phase_flags(step),
                    object_on=n_iters > 0 and step <= n_iters,
                    proj_use_deform=step <= n_iters and self.n_active > 2)

    def sample_draws(self, flags: dict) -> dict:
        draws = super().sample_draws(flags)
        if flags["object_on"]:
            ot = self.cfg.object_train
            draws["object"] = batching.draw_object_batch(self.generator, ot.N_rand, flags["n_active"],
                                                         self.device)
            draws["object_jitter"] = torch.rand((ot.N_rand, 1), generator=self.generator,
                                                device=self.device)
            draws["proj_view"] = int(torch.randint(0, flags["n_active"], (),
                                                   generator=self.host_generator))
        return draws

    def _trained(self, flags: dict) -> list:
        return (["obj"] if flags["object_on"] else []) + super()._trained(flags)

    def _loss(self, params: dict, step: int, flags: dict, draws: dict):
        return self.joint_loss(params["obj"], params["scene"], params["pose"], step, flags, draws)

    def object_loss(self, obj_p: dict, pose_p: dict, step: int, flags: dict, draws: dict):
        """The object half of the reference's `_step_impl.loss_fn`: (loss, metrics)."""
        cfg = self.cfg
        oc, ot = cfg.object_model, cfg.object_train
        n_active = flags["n_active"]
        current_pose = pose_refine.current_pose_pnp(pose_p, self.poses_pnp,
                                                    fix_first=self.fix_first_pose)
        if not flags["pose_on"]:
            current_pose = current_pose.detach()
        batch = batching.sample_object_batch(draws["object"], self.images, self.masks, self.Ks,
                                             current_pose, self.sampler_pixels, self.sampler_counts,
                                             self.data.inverse_y)
        render_out = object_sdf.render(
            obj_p, oc, batch.rays_o, batch.rays_d, batch.viewdirs, global_step=step,
            jitter=draws["object_jitter"], use_deform=True, is_train=True, near=self.data.near,
            far=self.data.far, bg=1.0 if self.data.white_bkgd else 0.0, mask_grid=self.mask_arr,
            mask_k=self._mask_k)
        k0_tv = object_losses_mod.k0_total_variation(obj_p)
        _, _, obj_loss, psnr = object_losses_mod.object_losses(
            render_out, batch.target, batch.mask, step, oc.N_iters, weight_main=ot.weight_main,
            weight_mask=ot.weight_mask, weight_tv_k0=ot.weight_tv_k0, k0_tv_value=k0_tv,
            use_deform=True, deform_prior_init=ot.weight_deform_prior_init,
            deform_prior_final=ot.weight_deform_prior_final)
        obj_loss = obj_loss + self._tv_density_loss(obj_p, step)
        metrics = {}
        if ot.weight_shell > 0:
            shell = object_losses_mod.shell_positivity_loss(obj_p["sdf_grid"], ot.shell_margin)
            obj_loss = obj_loss + ot.weight_shell * shell
            metrics["shell_loss"] = shell
        metrics["psnr_obj"] = psnr
        metrics["s_val"] = render_out["s_val"]
        if ot.projection_dis_error > 0:
            r = draws["proj_view"]
            pack = self.obj_matches[r]
            proj_err, near_surf = projection_losses.projection_error_loss(
                obj_p, oc, current_pose, self.Ks, coord_self=pack[:, 0:2], coord_other=pack[:, 2:4],
                mconf=pack[:, 4], id_i=int(self.pair_j[r]), id_j=r, global_step=step,
                inverse_y=self.data.inverse_y, use_deform=flags["proj_use_deform"], pixel_thre=200.0,
                near=self.data.near, far=self.data.far, mask_grid=self.mask_arr, mask_k=self._mask_k)
            obj_loss = obj_loss + ot.projection_dis_error * proj_err + ot.weight_near_surface * near_surf
            metrics["proj_err"] = proj_err
        return obj_loss, metrics

    def joint_loss(self, obj_p: dict, scene_p: dict, pose_p: dict, step: int, flags: dict,
                   draws: dict):
        """Total loss and metrics of one step: 0.1 * object loss + scene loss."""
        total, metrics = self.loss(scene_p, pose_p, step, flags, draws)
        if flags["object_on"]:
            obj_loss, obj_metrics = self.object_loss(obj_p, pose_p, step, flags, draws)
            total = total + 0.1 * obj_loss
            metrics = {**obj_metrics, **metrics, "loss_total": total}
        return total, metrics

    def _tv_density_loss(self, obj_p: dict, step: int):
        """weight_tv_density * (sdf TV + smoothed-grad TV), with the weights the
        `tv_updates` schedule has reached by `step`."""
        ot, oc = self.cfg.object_train, self.cfg.object_model
        if ot.weight_tv_density <= 0:
            return 0.0
        sdf_tv, smooth_tv = ot.sdf_tv, ot.smooth_grad_tv
        for ev_step, updates in ot.tv_updates:
            if step >= ev_step:
                upd = dict(updates)
                sdf_tv = upd.get("sdf_tv", sdf_tv)
                smooth_tv = upd.get("smooth_grad_tv", smooth_tv)
        total = 0.0
        if ot.sdf_tv > 0:
            total = total + grid_ops.total_variation(obj_p["sdf_grid"]) / 2.0 / oc.voxel_size * sdf_tv
        if ot.smooth_grad_tv > 0:
            grad = grid_ops.sdf_gradient_grid(obj_p["sdf_grid"], oc.voxel_size)
            kernel = object_losses_mod._tv_smooth_kernel(self.device)
            total = total + grid_ops.smooth_grad_tv(grad, kernel) * smooth_tv
        return ot.weight_tv_density * total

    def scale_volume_grid(self, num_voxels: int) -> None:
        """Progressive grid scaling: trilinear-resize the SDF and feature grids
        to the new resolution and restart the object optimizer."""
        new_cfg = dataclasses.replace(self.cfg.object_model, num_voxels=num_voxels)
        obj = dict(self.obj_params)
        with torch.no_grad():
            obj["sdf_grid"] = grid_ops.resize_trilinear(obj["sdf_grid"], new_cfg.world_size)
            obj["k0_grid"] = grid_ops.resize_trilinear(obj["k0_grid"], new_cfg.world_size)
        self.cfg = dataclasses.replace(self.cfg, object_model=new_cfg)
        self.obj_params = obj
        self.opt_obj_state = self.opt_obj.init(obj)

    def refresh_maskcache(self) -> None:
        """(Re)build the free-space occupancy mask.

        During the plastic object phase (step <= N_iters) geometry-dependent
        occupancy is never used: the mask is all-True and K is the tight
        per-ray chord bound over all training views (`max_inbbox_lanes`), so
        every in-box sample of every ray survives compaction --
        content-identical to the dense path -- while the lanes the
        box-diagonal budget wastes are cut. (Re-bounding K after pose drift,
        `update_plastic_chord_k`, belongs to the host pose events and is not
        ported yet.) Past the phase, occupancy is rebuilt from the mapped grid
        thresholded at the current NeuS sharpness and the configured K takes
        over."""
        om = self.cfg.object_model
        if self.global_step <= self.cfg.object_train.N_iters:
            self.mask_arr = torch.ones(self.obj_params["sdf_grid"].shape[1:], dtype=torch.bool,
                                       device=self.device)
            self._mask_k = self._k_phase
            return
        s_val = float(compositing.s_val_schedule(min(self.global_step, om.N_iters), om.s_ratio,
                                                 om.s_start, om.step_start))
        with torch.no_grad():
            mapped = object_sdf.processed_sdf_grid(self.obj_params, om)
        self.mask_arr = maskcache.build_mask_grid_mapped(
            mapped, s_val, sigma=om.maskcache_sigma, dilate=om.maskcache_dilate, prev=self.mask_arr)
        self._mask_k = None     # the config budget (maskcache_keep) past the phase

    def maybe_pg_scale(self, step: int) -> None:
        """Double the voxel count at each pg_scale checkpoint."""
        if step not in self._pg_scale:
            return
        n_rest = len(self._pg_scale) - self._pg_scale.index(step) - 1
        self.scale_volume_grid(int(self._final_num_voxels / (2 ** n_rest)))
        if self.cfg.object_model.use_maskcache:
            self.refresh_maskcache()

    def fit(self, num_steps: int) -> list:
        ot = self.cfg.object_train
        out = []
        for _ in range(num_steps):
            step = self.global_step
            self.maybe_pg_scale(step)
            if (self.cfg.object_model.use_maskcache and step > 0
                    and step <= ot.N_iters + ot.maskcache_update_every
                    and step % ot.maskcache_update_every == 0):
                self.refresh_maskcache()
            out.append(self.step())
        return out


def _leafify(tree):
    """Fresh autograd leaves sharing the params' storage."""
    return tree_unflatten(tree, [t.detach().requires_grad_(True) for t in tree_leaves(tree)])


def _add(params, updates):
    return tree_unflatten(params, [p + u for p, u in zip(tree_leaves(params),
                                                         tree_leaves(updates))])


def _bench_workload(small: bool, matmul_dtype: str):
    """bench.py's `build_trainer` configuration and data: a synthetic 3-view
    scene (300x300, or 64x64 when `small`); object branch 96^3 (24^3) SDF +
    12-channel k0 grids, 1024 (256) object rays, mask cache on; scene branch
    1024 scene rays (256), 128 + 128 samples (32 + 32), 256 matches (64), the
    8x256 trunk; the 60k-step schedule."""
    from ..config import config as cfg_mod
    from ..data.synthetic import make_synthetic_scene

    H = W = 64 if small else 300
    data = make_synthetic_scene(n_train=3, n_test=1, H=H, W=W, seed=0,
                                n_matches=64 if small else 256)
    margin = float(data.xyz_max[0])
    grid = 24 if small else 96
    cfg = cfg_mod.ExperimentConfig(
        data=cfg_mod.DataConfig(near=data.near, far=data.far),
        camera=cfg_mod.CameraConfig(incremental=True, fix_first_pose=True),
        pnp=cfg_mod.PnPConfig(use_pnp=False),
        object_model=object_sdf.ObjectConfig(
            xyz_min=(-margin,) * 3, xyz_max=(margin,) * 3, num_voxels=grid ** 3,
            num_voxels_base=grid ** 3, N_iters=N_ITERS, world_bound_scale=1.25,
            use_maskcache=True),
        object_train=cfg_mod.ObjectTrainConfig(N_iters=N_ITERS, N_rand=256 if small else 1024),
        scene_model=scene_nerf.SceneConfig(
            rand_rays=256 if small else 1024,
            sample_intvs=32 if small else 128,
            sample_intvs_fine=32 if small else 128,
            max_iter=MAX_ITER, fine_sampling=True,
            ratio_start_fine_sampling_at_x=FINE_START_RATIO,
            matmul_dtype=matmul_dtype),
        scene_train=cfg_mod.SceneTrainConfig(max_iter=MAX_ITER),
    )
    return cfg, data


def build_scene_trainer(small: bool = False, device="cuda",
                        matmul_dtype: str = "bfloat16") -> SceneTrainer:
    """bench.py's `build_trainer` workload with the object branch off (the
    coarse and mid phases)."""
    cfg, data = _bench_workload(small, matmul_dtype)
    return SceneTrainer(cfg, data, device=device)


def build_trainer(small: bool = False, device="cuda", matmul_dtype: str = "bfloat16") -> JointTrainer:
    """bench.py's `build_trainer` workload: the joint trainer, starting in the
    early phase (object + scene)."""
    cfg, data = _bench_workload(small, matmul_dtype)
    return JointTrainer(cfg, data, device=device)
