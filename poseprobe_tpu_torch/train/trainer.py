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
terms, the shell prior, the match-reprojection term and, while the pose
window is open, the surface-feature agreement term, mixed as
``0.1 * object_loss + scene_loss``, one backward pass and a third optimizer;
plus the mask cache (`refresh_maskcache`) and progressive grid scaling
(`scale_volume_grid`, `maybe_pg_scale`).

`JointTrainer.fit` is the host loop around the step, with the reference's
discrete events in the reference's order: the one-shot probe health check at
the end of the object phase, incremental view activation (PnP from the probe,
the scene or both; the px / holdout / photometric gates; the guarded
photometric warmup with its match guard; the rescue tournament; the
rescue-only match refinement), progressive grid scaling, re-registration, the
match-based BA polish, the mask-cache refresh, and the plastic chord-K
re-bound after every pose event. The events' pose arithmetic runs on the host
in numpy float64 (`core/align.py`, `pose_init/`); their renders (surface
anchors, warmup, fixed-ray scores, validation) run on the trainer's device.

Randomness is injected: `step(draws)` takes every random number of the step
(`sample_draws` draws them on the device from the trainer's generator when
the caller passes none), so a test can feed this step and the JAX step the
same numbers.

The step is graph-safe: it reads the step number from a device counter that
it advances, draws on the device, updates the params and the Adam state in
place and evaluates every schedule (lrs, bias corrections, NeuS sharpness,
loss weights) as tensor math, so it launches work on the device and never
waits for the host. `fit(superstep=K)` and `steps_scan(K)` are the
reference's `lax.scan` supersteps: on a card the K steps between host events
are one captured step replayed K - 1 times after an eager first step
(`train/graphs.py`), because the step is otherwise host-bound (its 1.6k-3.3k
kernels each cost a launch); on the CPU the same step runs K times.

With the corres term off, depth consistency renders its reference depth at
fresh pixels of a drawn view (`losses/scene.depth_consistency_loss`); with it
on, it reuses the corres pair's render. The object branch's k0 is dense or
TensoRF (`ops/tensorf.py`), rescaled by `scale_volume_grid` either way.
With ``mesh=`` (a ('data',) mesh of ranks, `parallel/mesh.py`) every rank
draws the whole batch, renders its share of the object rays and of the scene
and correspondence rays (and of each `render_full_image` chunk), the per-ray
outputs are gathered to every rank so each computes the same full loss, and
`_step_body` averages the gradients over the ranks in one all-reduce before
Adam; `fit` broadcasts rank 0's state after each step at which host events
may fire (`replicate_state`). On an NCCL mesh a superstep window is captured
with its all-reduce; on gloo it runs eagerly (``graph: False`` in the logged
metrics).
The step and the host loop mark their layers for a profiler
(`utils/profiling.span`: `poseprobe.step.*` around the draws, the batch, each
loss group, the backward and the optimizer; `poseprobe.host.*` around eager
steps, replays and the step setter). Beside the
reference's metrics the step reports `feat_rays` (the feature term's valid
rays) and, with the mask cache, `maskcache_fill` (the in-mask share of the
object render's lanes after compaction).
`host_extras` / `restore_host_extras` hold the host-side state that
`train/state.py`'s checkpoints carry beside the tensors
(the generator, the mask cache and its budgets, the object voxel count).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..config.config import ExperimentConfig
from ..core import align as align_mod, pose as pose_ops, rays as rays_mod
from ..core.graphsafe import take
from ..core.tree import tree_leaves, tree_unflatten
from ..data.base import SceneData
from ..eval import evaluator
from ..eval.vgg_features import get_multi_features
from ..losses import (common as loss_common, object as object_losses_mod,
                      projection as projection_losses, scene as scene_losses)
from ..models import object_sdf, pose_refine, scene_nerf
from ..ops import compositing, grid as grid_ops, maskcache, ray_sampling, tensorf
from ..parallel import mesh as mesh_mod
from ..pose_init import ba as ba_mod, pnp as pnp_mod
from ..utils.profiling import span
from . import batching, graphs
from .optim import ObjectOptimizer, PoseOptimizer, SceneOptimizer

# bench.py's workload constants (the 60k-step schedule at reference scale)
N_ITERS = 10000
MAX_ITER = 60000
FINE_START_RATIO = 0.3


class ProbeHealthError(RuntimeError):
    """The object probe died during its training phase (default-on invariant).

    Raised at the end of the object phase when the raw SDF grid shows a
    catastrophic signature. The probe is the method's thesis: a run that loses
    it must abort, not silently pass on warmup- or BA-carried poses.

    Signatures:
    * evaporation -- frac_neg ~ 0: no negative voxels, no interior, PnP
      anchors come from an empty surface;
    * filled box -- frac_neg ~ 1: raw grid negative out to the bbox faces,
      mesh extraction empty.
    Disable only for probe-less or scene-only experiments via
    ``object_train.probe_health_check=False``.
    """


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class SceneTrainer:
    """Owns the device data, scene/pose params, optimizer states and the step.

    With ``pnp.use_pnp`` the poses are seeded by the PnP chain against the
    cube-initialised probe SDF (with ``use_identical``, by the first view's
    pose), as in the reference; the host pose events that follow the seeding
    belong to `JointTrainer.fit`."""

    GROUPS = ("scene", "pose")

    def __init__(self, cfg: ExperimentConfig, data: SceneData, seed: int | None = None,
                 device="cuda", mesh=None):
        self.cfg, self.data = cfg, data
        self.device = torch.device(device)
        self.mesh = mesh    # a ('data',) mesh of ranks for ray data parallelism (None: one rank)
        seed = cfg.seed if seed is None else seed
        init_gen = torch.Generator().manual_seed(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        # the step number on the device: the step reads it and advances it
        self._step_t = torch.zeros((), dtype=torch.int64, device=self.device)
        self._graphs = graphs.GraphCache()
        self._metrics_hist: list = []

        def dev(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

        it = data.i_train
        self.images = dev(data.images[it])
        self.Ks = dev(data.Ks[it])
        self.poses_gt = dev(data.poses_gt_w2c[it])
        self.scene_matches = dev(data.scene_matches)
        self.pair_j = np.asarray(data.pair_j)
        self.pair_j_t = dev(self.pair_j, torch.int64)
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
        # pose initialisation: the PnP chain (host) or noisy GT
        if cfg.pnp.use_pnp or cfg.pnp.use_identical:
            self.poses_pnp = dev(pnp_mod.initialize_poses_pnp(
                self._probe_params(seed), cfg.object_model, data, use_identical=cfg.pnp.use_identical))
        else:
            self.poses_pnp = pose_ops.compose_pair(pose_noise.to(self.device), self.poses_gt)
        # the PnP chain runs on every rank (OpenCV's RANSAC may draw differently): rank 0's seeds
        mesh_mod.replicated(self.poses_pnp, mesh)

        rot_window = int(sc.max_iter * sc.ratio_end_joint_nerf_pose_refinement)
        trans_window = (None if sc.ratio_end_pose_trans is None
                        else int(sc.max_iter * sc.ratio_end_pose_trans))
        self.pose_window = max(rot_window, trans_window or 0)
        self.opt_scene = SceneOptimizer(sc)
        self.opt_pose = PoseOptimizer(cfg.object_train, rot_window, trans_window)
        self.opt_scene_state = self.opt_scene.init(self.scene_params)
        self.opt_pose_state = self.opt_pose.init(self.pose_params)

        self.global_step = 0
        self.best_val = -1.0
        self.n_active = 2 if (cfg.camera.incremental and self.n_train > 2) else self.n_train
        self.fine_start = (int(sc.max_iter * sm.ratio_start_fine_sampling_at_x)
                           if sm.ratio_start_fine_sampling_at_x is not None else 0)
        self.depth_cons_start = (int(sc.max_iter * sc.start_ratio_depth_cons)
                                 if sc.start_ratio_depth_cons is not None else -1)

    def _probe_params(self, seed: int) -> dict:
        """The object probe's initial params: the cube SDF with the voxels
        near the cameras masked out (a function of `seed` alone)."""
        om = self.cfg.object_model
        obj = object_sdf.init_object_params(torch.Generator().manual_seed(seed + 3), om, self.device)
        cam_centers = _np(pose_ops.invert(self.poses_gt)[:, :3, 3])
        return object_sdf.maskout_near_cam_vox(obj, om, cam_centers, self.data.near)

    @property
    def global_step(self) -> int:
        """The number of the next step (the host's copy of the device counter)."""
        return self._global_step

    @global_step.setter
    def global_step(self, step: int) -> None:
        with span("poseprobe.host.set_step"):
            self._global_step = int(step)
            self._step_t.fill_(self._global_step)

    @property
    def fix_first_pose(self) -> bool:
        if self.cfg.camera.fix_first_pose is not None:
            return bool(self.cfg.camera.fix_first_pose)
        return bool(self.cfg.pnp.use_pnp or self.cfg.pnp.use_identical)

    def current_pose_host(self) -> np.ndarray:
        """Host-float64 pose composition [n_train, 3, 4] for the metric, eval
        and pose-event paths (`core/align.py` says why not the device's)."""
        return align_mod.current_pose_pnp_host(_np(self.pose_params["se3_refine"]),
                                               _np(self.poses_pnp), fix_first=self.fix_first_pose)

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
            "corres_view": torch.randint(0, n_active, (), generator=self.generator, device=self.device),
            "render": ray_sampling.draw_render_noise(self.generator, 1, n_rays, sm.sample_intvs,
                                                     sm.sample_intvs_fine, self.device),
        }
        if flags["depth_cons_on"]:
            draws["dc_interp_w"] = torch.rand((), generator=self.generator, device=self.device)
            if sc.loss_weight_dict().get("corres") is not None:
                # the corres pair's self-view pixels are the reference pixels
                draws["dc_render"] = ray_sampling.draw_render_noise(
                    self.generator, 1, M, sm.sample_intvs, sm.sample_intvs_fine, self.device)
            else:
                # fresh reference pixels in a drawn view, and the draws of
                # their render and of the render at the unseen pose
                n_ref = max(256, sm.rand_rays)
                u = torch.rand((2, n_ref), generator=self.generator, device=self.device)
                draws["dc_view"] = torch.randint(0, n_active, (), generator=self.generator,
                                                 device=self.device)
                draws["dc_pixels"] = torch.stack([u[0] * (self.W - 2), u[1] * (self.H - 2)], -1)
                draws["dc_render_ref"], draws["dc_render"] = (ray_sampling.draw_render_noise(
                    self.generator, 1, n_ref, sm.sample_intvs, sm.sample_intvs_fine, self.device)
                    for _ in range(2))
        return draws

    def loss(self, scene_p: dict, pose_p: dict, step, flags: dict, draws: dict):
        """Total scene loss and metrics of one step (the scene half of the
        reference's `_step_impl.loss_fn`); `step` is an int or the 0-dim step
        counter."""
        cfg = self.cfg
        sc, sm = cfg.scene_train, cfg.scene_model
        n_active = flags["n_active"]
        step = self._as_step(step)
        progress = torch.clamp(step / sm.max_iter, 0.0, 1.0)
        depth_range = (self.data.near, self.data.far)

        lw = sc.loss_weight_dict()
        use_corres = lw.get("corres") is not None
        use_dc = flags["depth_cons_on"] and lw.get("depth_cons") is not None
        scene_pc = scene_nerf.cast_mlp_params(scene_p, sm.matmul_dtype)
        with span("poseprobe.step.batch"):
            current_pose = pose_refine.current_pose_pnp(pose_p, self.poses_pnp,
                                                        fix_first=self.fix_first_pose)
            if not flags["pose_on"]:
                # pose window closed: no pose update, so no gradient into the poses
                current_pose = current_pose.detach()
            active_pose, active_K = current_pose[:n_active], self.Ks[:n_active]
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

            # the main rays and the corres pair rays go through ONE render call
            center_all = center_m.reshape(1, R_main, 3)
            ray_all = ray_m.reshape(1, R_main, 3)
            if use_corres:
                r = draws["corres_view"]
                pack = take(self.scene_matches, r)
                px_self, px_other, conf = pack[:, 2:4], pack[:, 0:2], pack[:, 4]
                id_self, id_other = r, take(self.pair_j_t, r)
                center_c, ray_c = scene_losses.correspondence_pair_rays(
                    current_pose, self.Ks, px_self, px_other, id_self, id_other)
                M = center_c.shape[1]
                center_all = torch.cat([center_all, center_c.reshape(1, 2 * M, 3)], dim=1)
                ray_all = torch.cat([ray_all, ray_c.reshape(1, 2 * M, 3)], dim=1)
        # with a mesh: this rank's share of the rays, then every rank's outputs on every rank
        R_all = center_all.shape[1]
        noise = dict(draws["render"], jitter=mesh_mod.shard_rays(draws["render"]["jitter"][:, :R_all],
                                                                  self.mesh, axis=1))
        rets_all = scene_nerf.render_rays(scene_pc, sm, mesh_mod.shard_rays(center_all, self.mesh, axis=1),
                                          mesh_mod.shard_rays(ray_all, self.mesh, axis=1), depth_range,
                                          progress, noise=noise, compute_fine=flags["fine_on"])
        rets_all = mesh_mod.unshard_rays({k: v for k, v in rets_all.items() if k not in ("origins", "viewdirs")},
                                         R_all, self.mesh, axis=1)

        rets = {k: v[:, :R_main].reshape((n_active, R_v) + v.shape[2:]) for k, v in rets_all.items()}
        with span("poseprobe.step.scene_losses"):
            loss_dict = dict(scene_losses.photometric_and_regu_loss(rets, sbatch.target, sc))
            if use_corres:
                depth_pair = rets_all["depth"][0, R_main:, 0].reshape(2, M)
                depth_fine_pair = (rets_all["depth_fine"][0, R_main:, 0].reshape(2, M)
                                   if "depth_fine" in rets_all else None)
                loss_dict["corres"] = scene_losses.correspondence_loss_from_depths(
                    depth_pair, depth_fine_pair, current_pose, self.Ks, px_self, px_other, conf,
                    id_self, id_other, step, sc)
        if use_dc:
            with span("poseprobe.step.depth_cons"):
                if not use_corres:
                    # no corres term: a fresh reference render at drawn pixels
                    loss_dict["depth_cons"] = scene_losses.depth_consistency_loss(
                        scene_pc, sm, active_pose, active_K, draws["dc_pixels"], draws["dc_view"],
                        interp_w=draws["dc_interp_w"], H=self.H, W=self.W, depth_range=depth_range,
                        progress=progress, iteration=step, compute_fine=flags["fine_on"],
                        use_fine_depth_as_ref=flags["fine_on"], opt=sc, noise_ref=draws["dc_render_ref"],
                        noise=draws["dc_render"])
                else:
                    # the corres pair's self-view pixels and their depth are the reference
                    d_ref = depth_fine_pair[0] if depth_fine_pair is not None else depth_pair[0]
                    loss_dict["depth_cons"] = scene_losses.depth_consistency_from_ref_depth(
                        scene_pc, sm, active_pose, active_K, px_self, d_ref, id_self,
                        interp_w=draws["dc_interp_w"], H=self.H, W=self.W, depth_range=depth_range,
                        progress=progress, iteration=step, compute_fine=flags["fine_on"], opt=sc,
                        noise=draws["dc_render"], ref_valid=conf > 0)
        with span("poseprobe.step.scene_losses"):
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

    def _loss(self, params: dict, step, flags: dict, draws: dict):
        return self.loss(params["scene"], params["pose"], step, flags, draws)

    def _as_step(self, step) -> torch.Tensor:
        """`step` as a 0-dim int64 tensor on the device (filled on the device
        from an int: no host copy)."""
        if isinstance(step, torch.Tensor):
            return step
        return torch.full((), step, dtype=torch.int64, device=self.device)

    def _step_body(self, flags: dict, draws: dict | None = None) -> dict:
        """One training step on the device, graph-safe: draws (unless given),
        loss, one backward pass, the optimizers' in-place updates of the
        params and their state, and the advance of the step counter. Returns
        the metrics (0-dim tensors on the device)."""
        if draws is None:
            with span("poseprobe.step.draws"):
                draws = self.sample_draws(flags)
        names = self._trained(flags)
        params = {n: getattr(self, f"{n}_params") for n in self.GROUPS}
        params.update({n: _leafify(params[n]) for n in names})
        total, metrics = self._loss(params, self._step_t, flags, draws)

        leaves = [tree_leaves(params[n]) for n in names]
        flat = [x for group in leaves for x in group]
        with span("poseprobe.step.backward"):
            grads = torch.autograd.grad(total, flat, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
            if self.mesh is not None:
                grads = mesh_mod.mean_grads(grads, self.mesh)
        start = 0
        with torch.no_grad(), span("poseprobe.step.optimizer"):
            for n, group in zip(names, leaves):
                own = getattr(self, f"{n}_params")
                g = tree_unflatten(own, grads[start:start + len(group)])
                start += len(group)
                up, state = getattr(self, f"opt_{n}").update(g, getattr(self, f"opt_{n}_state"))
                setattr(self, f"opt_{n}_state", state)
                torch._foreach_add_(tree_leaves(own), tree_leaves(up))
            self._step_t.add_(1)
        return {k: v.detach() for k, v in metrics.items()}

    def step(self, draws: dict | None = None) -> dict:
        """One training step, run eagerly; returns its metrics (0-dim tensors
        on the device)."""
        with span("poseprobe.host.eager_step"):
            metrics = self._step_body(self.phase_flags(self.global_step), draws)
        self._global_step += 1
        return metrics

    # ------------------------------------------------------------ supersteps

    def _next_boundary(self, step: int) -> int:
        """First step > `step` at which a host event fires or a phase flag
        flips: a superstep window starting at `step` must end by then."""
        cfg = self.cfg
        cands = [self.pose_window, self.fine_start, self.depth_cons_start,
                 cfg.scene_train.precrop_iters]
        return min([c for c in cands if c > step], default=step + 1_000_000_000)

    def steps_scan(self, k: int) -> dict:
        """`k` steps as one window; returns the stacked [k] metrics.

        Refuses a window that would cross a host event or a phase-flag flip
        (`_next_boundary`); `fit` never asks for one. On a card the first
        step of a cell runs eagerly under `torch.cuda.set_sync_debug_mode
        ("error")` (a step that waits for the host raises), is then captured
        as a CUDA graph and replayed for the other k - 1 steps; later windows
        of the cell replay the captured step k times. Capture or replay
        failing raises. On the CPU the same step runs k times."""
        step = self.global_step
        if self._next_boundary(step) < step + k:
            raise ValueError(f"window [{step}, {step + k}) crosses a host event or a phase flip at "
                             f"step {self._next_boundary(step)}")
        flags = self.phase_flags(step)
        if not self.graph_windows:
            rows = [self.step() for _ in range(k)]
            return {key: torch.stack([r[key] for r in rows]) for key in rows[0]}
        key = self._cell(flags)
        graph = self._graphs.get(key, self.state_tensors())
        rows = []
        if graph is None:
            with graphs.sync_debug_error(), span("poseprobe.host.eager_step"):
                first = self._step_body(flags)
            self._global_step += 1
            rows.append(torch.stack(list(first.values())))
            graph = self._graphs.put(key, graphs.StepGraph(lambda: self._step_body(flags),
                                                           self.state_tensors(), self.generator))
        while len(rows) < k:
            with span("poseprobe.host.replay"):
                graph.replay()
                rows.append(graph.packed.clone())
            self._global_step += 1
        hist = torch.stack(rows)
        return {name: hist[:, j] for j, name in enumerate(graph.outputs)}

    @property
    def graph_windows(self) -> bool:
        """Whether a superstep window replays a captured CUDA graph: on a card,
        alone or over an NCCL mesh; a gloo mesh's collectives stage through the
        host and cannot be captured, so there a window runs its steps eagerly."""
        return self.device.type == "cuda" and (self.mesh is None or self.mesh.capturable)

    def _cell(self, flags: dict) -> tuple:
        """What a captured step is specific to: the phase flags, the active
        views (in the flags), the mask-cache budget, the config, the scatter
        barrier switch and the shapes of the state."""
        return (tuple(sorted(flags.items())), getattr(self, "_mask_k", None), self.cfg,
                grid_ops._scatter_barrier(), tuple(tuple(t.shape) for t in self.state_tensors()))

    def state_tensors(self) -> list:
        """The persistent tensors the step reads or writes in place: the step
        counter, the seeded poses, the mask cache, the params and their
        optimizer states. A captured step is replayed only while each is the
        tensor it captured: a host event that rebinds one (new seeded poses, a
        mask-cache refresh, a grid rescale, a caller loading a state) drops
        the graph, and the next window captures the step again."""
        out = [self._step_t, self.poses_pnp, getattr(self, "mask_arr", None)]
        for n in self.GROUPS:
            out += tree_leaves(getattr(self, f"{n}_params"))
            state = getattr(self, f"opt_{n}_state")
            if state is not None:
                out += [state["count"]] + tree_leaves(state["mu"]) + tree_leaves(state["nu"])
        return [t for t in out if t is not None]

    def replicate_state(self) -> None:
        """Rank 0's state on every rank of the mesh, bit for bit: the state
        tensors (in place, so a captured step stays valid) and the host ints
        the step reads. `fit` calls it after each step at which host events
        may fire: they run on every rank, through host floats and OpenCV."""
        names = [n for n in ("n_active", "_mask_k", "_k_phase") if hasattr(self, n)]
        ints = torch.tensor([-1 if getattr(self, n) is None else getattr(self, n) for n in names],
                            dtype=torch.int64, device=self.device)
        mesh_mod.replicated(self.state_tensors() + [ints], self.mesh)
        for n, v in zip(names, ints.tolist()):
            setattr(self, n, None if v < 0 else v)

    def drop_graphs(self) -> None:
        """Drop the captured steps and free their memory pools."""
        self._graphs.clear()

    # ---------------------------------------------------------- ckpt extras

    def host_extras(self) -> dict:
        """Host-side state for an exact resume (`train/state.py`'s extras), as
        arrays: the state of the device generator the step draws from
        (`generator`, uint8: on the card its seed and offset, which graph
        replays advance)."""
        return {"generator": self.generator.get_state().numpy()}

    def restore_host_extras(self, extras: dict) -> None:
        """Inverse of `host_extras`; names it does not know are ignored. A JAX
        checkpoint holds the loop key of a JAX PRNG stream (`loop_key`), which
        torch cannot reproduce: without `generator` the trainer keeps its own
        generator, so the run resumes, but not draw for draw."""
        self.drop_graphs()
        if "generator" in extras:
            self.generator.set_state(torch.as_tensor(np.asarray(extras["generator"], np.uint8)))

    def _host_events(self, step: int) -> None:
        """The host events that fire before `step` (`JointTrainer` has them)."""

    def fit(self, num_steps: int, log_every: int = 0, callback=None, superstep: int = 1) -> list:
        """Host loop: `num_steps` steps with the host events before each, in
        the reference's order. With ``superstep=K > 1`` the steps between
        host events run as K-step windows (`steps_scan`) wherever K steps
        remain before the next event, phase flip or log step, and as single
        steps elsewhere. With `log_every`, the metrics of every
        `log_every`-th step (a window's last) are brought to the host,
        checked for a non-finite loss, appended to the history (which is
        returned) and passed to `callback`."""
        end_step = self.global_step + num_steps
        while self.global_step < end_step:
            step = self.global_step
            # the boundary test comes before the events, which may remove the boundary they fire at
            event_step = step > 0 and self._next_boundary(step - 1) == step
            self._host_events(step)
            if self.mesh is not None and event_step:
                self.replicate_state()
            limit = min(end_step, self._next_boundary(step))
            if log_every:   # windows end exactly on log steps
                limit = min(limit, ((step // log_every) + 1) * log_every)
            if superstep > 1 and limit - step >= superstep:
                metrics = {k: v[-1] for k, v in self.steps_scan(superstep).items()}
            else:
                metrics = self.step()
            if log_every and self.global_step % log_every == 0:
                host = {k: float(v) for k, v in metrics.items()}
                if not np.isfinite(host.get("loss_total", 0.0)):
                    raise FloatingPointError(f"non-finite loss at step {self.global_step}: {host}")
                host["step"] = self.global_step
                host["n_active"] = self.n_active
                if self.mesh is not None:
                    host["graph"] = superstep > 1 and self.graph_windows
                self._metrics_hist.append(host)
                if callback is not None:
                    callback(host)
        return self._metrics_hist

    def render_full_image(self, pose_w2c, K, chunk: int = 2048, fine: bool = True) -> dict:
        """Chunked full-image render of the scene branch at the trainer's
        training progress: {'rgb', 'depth', 'opacity', 'depth_var'}, each
        [H, W, C]; the fine network's output when `fine` and the config
        samples fine."""
        sm = self.cfg.scene_model
        out = evaluator.render_full(self.scene_params, sm, pose_w2c, K, self.H, self.W,
                                    (self.data.near, self.data.far), chunk=chunk,
                                    use_fine=bool(fine and sm.fine_sampling),
                                    progress=min(self.global_step / sm.max_iter, 1.0), mesh=self.mesh)
        return {k: out[k] for k in ("rgb", "depth", "opacity", "depth_var")}

    def validate(self, n_views: int = 5) -> float:
        """Validation PSNR over (up to) `n_views` test views rendered in the
        optimized frame: align the current train poses to GT, backtrack the
        test poses through the inverse sim3, render, and return the mean PSNR.
        Updates `best_val`."""
        data, sm = self.data, self.cfg.scene_model
        if len(data.i_test) == 0:
            return float("nan")
        _, sim3 = evaluator.align_train_poses(self.current_pose_host(), _np(self.poses_gt))
        # before fine sampling starts training the fine MLP is untrained: score
        # the coarse output. progress must match training: the BARF-masked PE
        # bands have untrained weights until the c2f window closes.
        fine_trained = bool(sm.fine_sampling and self.global_step >= self.fine_start)
        progress = min(self.global_step / sm.max_iter, 1.0)
        psnrs = []
        for i in data.i_test[:n_views]:
            pose_t = align_mod.backtrack_from_aligning_the_trajectory(data.poses_gt_w2c[i][None], sim3)[0]
            out = evaluator.render_full(self.scene_params, sm, pose_t, data.Ks[i], self.H, self.W,
                                        (data.near, data.far), use_fine=fine_trained, progress=progress)
            gt = torch.as_tensor(np.asarray(data.images[i]), dtype=torch.float32, device=self.device)
            mse = float(((out["rgb"] - gt) ** 2).mean())
            psnrs.append(-10.0 * math.log10(max(mse, 1e-12)))
        val = float(np.mean(psnrs))
        self.best_val = max(self.best_val, val)
        return val


class JointTrainer(SceneTrainer):
    """`SceneTrainer` plus the object branch: the full joint step."""

    GROUPS = ("obj", "scene", "pose")

    def __init__(self, cfg: ExperimentConfig, data: SceneData, seed: int | None = None,
                 device="cuda", mesh=None):
        ot = cfg.object_train
        # progressive scaling: start at num_voxels / 2^len(pg_scale) and double
        # the voxel count at each checkpoint step
        self._pg_scale = tuple(ot.pg_scale)
        self._final_num_voxels = cfg.object_model.num_voxels
        if self._pg_scale:
            shrunk = int(cfg.object_model.num_voxels / (2 ** len(self._pg_scale)))
            cfg = dataclasses.replace(cfg, object_model=dataclasses.replace(
                cfg.object_model, num_voxels=shrunk))
        super().__init__(cfg, data, seed=seed, device=device, mesh=mesh)
        seed = cfg.seed if seed is None else seed
        dev = lambda a, dtype=torch.float32: torch.as_tensor(  # noqa: E731
            np.asarray(a), dtype=dtype, device=self.device)
        it = data.i_train
        self.masks = dev(data.masks[it])
        self.sampler_pixels = dev(data.samplers.pixels, torch.int64)
        self.sampler_counts = dev(data.samplers.counts, torch.int64)
        self.obj_matches = dev(data.obj_matches)
        # feature maps of the train views for the surface-feature agreement term
        self.feature_maps = None
        if ot.weight_surface_projection > 0:
            self.feature_maps = get_multi_features(data.images[it], device=self.device)

        om = cfg.object_model
        self.obj_params = self._probe_params(seed)
        self._probe_checked = False     # the one-shot end-of-object-phase invariant
        self.opt_obj = ObjectOptimizer(ot)
        self.opt_obj_state = self.opt_obj.init(self.obj_params)

        # Free-space-skipping occupancy cache. _k_phase: the tight per-ray
        # chord bound of the plastic-phase compaction, over the GT and the
        # seeded poses so pose drift stays inside the margin.
        self.mask_arr = None
        self._mask_k = None
        self._k_phase = None
        if om.use_maskcache:
            all_poses = np.concatenate([_np(self.poses_gt), _np(self.poses_pnp)])
            all_Ks = np.concatenate([_np(self.Ks)] * 2)
            self._k_phase = min(om.n_samples, maskcache.max_inbbox_lanes(
                all_poses, all_Ks, self.H, self.W, om.xyz_min_np, om.xyz_max_np,
                om.stepsize * om.voxel_size))
            self.refresh_maskcache()

    def host_extras(self) -> dict:
        """`SceneTrainer.host_extras` plus the mask cache (`mask_arr`, bool),
        its lane budget (`mask_k`), the plastic-phase chord bound (`k_phase`)
        and the trainer's object voxel count (`num_voxels`), which progressive
        scaling has reached; int64 scalars, each where set."""
        ex = super().host_extras()
        ex["num_voxels"] = np.int64(self.cfg.object_model.num_voxels)
        if self.mask_arr is not None:
            ex["mask_arr"] = _np(self.mask_arr)
        for name, val in (("mask_k", self._mask_k), ("k_phase", self._k_phase)):
            if val is not None:
                ex[name] = np.int64(val)
        return ex

    def restore_host_extras(self, extras: dict) -> None:
        """Inverse of `host_extras`. The object config takes the saved voxel
        count; a JAX checkpoint has none, and then it takes the count of the
        pg_scale schedule whose grid has the shape of the loaded SDF grid, so
        that the step size, the sample count and the mask-cache budget follow
        the grid (the JAX trainer keeps the shrunk template's count there)."""
        super().restore_host_extras(extras)
        om = self.cfg.object_model
        shape = tuple(self.obj_params["sdf_grid"].shape[1:])
        if "num_voxels" in extras:
            counts = [int(extras["num_voxels"])]
        else:
            counts = [int(self._final_num_voxels / 2 ** k) for k in range(len(self._pg_scale) + 1)]
        fits = [n for n in counts if dataclasses.replace(om, num_voxels=n).world_size == shape]
        if not fits:
            raise ValueError(f"the loaded SDF grid {shape} is no grid of voxel count {counts}")
        self.cfg = dataclasses.replace(self.cfg, object_model=dataclasses.replace(om, num_voxels=fits[0]))
        if "mask_arr" in extras:
            self.mask_arr = torch.as_tensor(np.asarray(extras["mask_arr"], bool), device=self.device)
        if "mask_k" in extras:
            self._mask_k = int(extras["mask_k"])
        if "k_phase" in extras:
            self._k_phase = int(extras["k_phase"])

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
            draws["proj_view"] = torch.randint(0, flags["n_active"], (), generator=self.generator,
                                               device=self.device)
            if self._feature_term_on(flags):
                draws["feat_view"] = torch.randint(0, flags["n_active"], (), generator=self.generator,
                                                   device=self.device)
        return draws

    def _feature_term_on(self, flags: dict) -> bool:
        """Whether the step adds the surface-feature agreement term: with its
        weight, while the object branch and the pose window are on."""
        return bool(self.cfg.object_train.weight_surface_projection > 0 and flags["object_on"]
                    and flags["pose_on"] and self.feature_maps is not None)

    def _cell(self, flags: dict) -> tuple:
        return super()._cell(flags) + (self._feature_term_on(flags),)

    def _trained(self, flags: dict) -> list:
        return (["obj"] if flags["object_on"] else []) + super()._trained(flags)

    def _loss(self, params: dict, step, flags: dict, draws: dict):
        return self.joint_loss(params["obj"], params["scene"], params["pose"], step, flags, draws)

    def object_loss(self, obj_p: dict, pose_p: dict, step, flags: dict, draws: dict):
        """The object half of the reference's `_step_impl.loss_fn`: (loss, metrics)."""
        cfg = self.cfg
        oc, ot = cfg.object_model, cfg.object_train
        step = self._as_step(step)
        step_f = step.to(torch.float32)
        with span("poseprobe.step.batch"):
            current_pose = pose_refine.current_pose_pnp(pose_p, self.poses_pnp,
                                                        fix_first=self.fix_first_pose)
            if not flags["pose_on"]:
                current_pose = current_pose.detach()
            batch = batching.sample_object_batch(draws["object"], self.images, self.masks, self.Ks,
                                                 current_pose, self.sampler_pixels, self.sampler_counts,
                                                 self.data.inverse_y)
        shard = lambda x: mesh_mod.shard_rays(x, self.mesh)  # noqa: E731
        render_out = object_sdf.render(
            obj_p, oc, shard(batch.rays_o), shard(batch.rays_d), shard(batch.viewdirs), global_step=step_f,
            jitter=shard(draws["object_jitter"]), use_deform=True, is_train=True, near=self.data.near,
            far=self.data.far, bg=1.0 if self.data.white_bkgd else 0.0, mask_grid=self.mask_arr,
            mask_k=self._mask_k)
        render_out = mesh_mod.unshard_rays(render_out, batch.rays_o.shape[0], self.mesh)
        metrics = {}
        with span("poseprobe.step.object_losses"):
            k0_tv = object_losses_mod.k0_total_variation(obj_p)
            _, _, obj_loss, psnr = object_losses_mod.object_losses(
                render_out, batch.target, batch.mask, step_f, oc.N_iters, weight_main=ot.weight_main,
                weight_mask=ot.weight_mask, weight_tv_k0=ot.weight_tv_k0, k0_tv_value=k0_tv,
                use_deform=True, deform_prior_init=ot.weight_deform_prior_init,
                deform_prior_final=ot.weight_deform_prior_final)
            obj_loss = obj_loss + self._tv_density_loss(obj_p, step)
            if ot.weight_shell > 0:
                shell = object_losses_mod.shell_positivity_loss(obj_p["sdf_grid"], ot.shell_margin)
                obj_loss = obj_loss + ot.weight_shell * shell
                metrics["shell_loss"] = shell
            metrics["psnr_obj"] = psnr
            metrics["s_val"] = render_out["s_val"]
            if self.mask_arr is not None:
                # the in-mask share of the lanes the render computed after compaction
                # (the port's own metric)
                metrics["maskcache_fill"] = render_out["mask"].float().mean()
        if ot.projection_dis_error > 0:
            with span("poseprobe.step.projection"):
                r = draws["proj_view"]
                pack = take(self.obj_matches, r)
                proj_err, near_surf = projection_losses.projection_error_loss(
                    obj_p, oc, current_pose, self.Ks, coord_self=pack[:, 0:2], coord_other=pack[:, 2:4],
                    mconf=pack[:, 4], id_i=take(self.pair_j_t, r), id_j=r, global_step=step_f,
                    inverse_y=self.data.inverse_y, use_deform=flags["proj_use_deform"], pixel_thre=200.0,
                    near=self.data.near, far=self.data.far, mask_grid=self.mask_arr, mask_k=self._mask_k)
                obj_loss = obj_loss + ot.projection_dis_error * proj_err + ot.weight_near_surface * near_surf
                metrics["proj_err"] = proj_err
        if self._feature_term_on(flags):
            with span("poseprobe.step.feature"):
                r2 = draws["feat_view"]
                n_feat_rays = min(256, ot.N_rand)
                feat_loss, n_valid = projection_losses.surface_feature_loss(
                    obj_p, oc, current_pose, self.Ks, batch.rays_o[:n_feat_rays],
                    batch.rays_d[:n_feat_rays], id_i=r2, id_j=take(self.pair_j_t, r2),
                    feature_maps=self.feature_maps, global_step=step_f, inverse_y=self.data.inverse_y,
                    use_deform=True, near=self.data.near, far=self.data.far)
                obj_loss = obj_loss + ot.weight_surface_projection * feat_loss
                metrics["feat_loss"] = feat_loss
                metrics["feat_rays"] = n_valid      # the valid rays of the term (the port's own metric)
        return obj_loss, metrics

    def joint_loss(self, obj_p: dict, scene_p: dict, pose_p: dict, step, flags: dict,
                   draws: dict):
        """Total loss and metrics of one step: 0.1 * object loss + scene loss;
        `step` is an int or the 0-dim step counter."""
        step = self._as_step(step)
        total, metrics = self.loss(scene_p, pose_p, step, flags, draws)
        if flags["object_on"]:
            obj_loss, obj_metrics = self.object_loss(obj_p, pose_p, step, flags, draws)
            total = total + 0.1 * obj_loss
            metrics = {**obj_metrics, **metrics, "loss_total": total}
        return total, metrics

    def _tv_density_loss(self, obj_p: dict, step: torch.Tensor):
        """weight_tv_density * (sdf TV + smoothed-grad TV), with the weights the
        `tv_updates` schedule has reached by the step tensor `step`."""
        ot, oc = self.cfg.object_train, self.cfg.object_model
        if ot.weight_tv_density <= 0:
            return 0.0
        sdf_tv, smooth_tv = tv_weights(ot, step)
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
            if isinstance(obj["k0_grid"], dict):     # TensoRF planes and vectors
                obj["k0_grid"] = tensorf.tensorf_resize(obj["k0_grid"], new_cfg.world_size)
            else:
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
        box-diagonal budget wastes are cut; past step 0 the bound is taken
        again for the current poses (`update_plastic_chord_k`: joint
        refinement drifts poses between refreshes too). Past the phase, occupancy is rebuilt from the mapped grid
        thresholded at the current NeuS sharpness and the configured K takes
        over."""
        om = self.cfg.object_model
        if self.global_step <= self.cfg.object_train.N_iters:
            self.mask_arr = torch.ones(self.obj_params["sdf_grid"].shape[1:], dtype=torch.bool,
                                       device=self.device)
            self._mask_k = self._k_phase
            if self.global_step > 0:
                self.update_plastic_chord_k()
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

    # ------------------------------------------------------------ pose events

    def _set_poses(self, poses_pnp: np.ndarray, zero_refine: int = 0) -> None:
        """Write new seeded poses; restart the first `zero_refine` refinement rows from zero."""
        self.poses_pnp = torch.as_tensor(np.asarray(poses_pnp), dtype=torch.float32, device=self.device)
        if zero_refine:
            refine = self.pose_params["se3_refine"].clone()
            refine[:zero_refine] = 0.0
            self.pose_params = dict(self.pose_params, se3_refine=refine)

    def _render_state(self, step: int) -> dict:
        """BARF progress and fine flag that match the scene's training at `step`."""
        sm = self.cfg.scene_model
        return dict(progress=min(step / sm.max_iter, 1.0),
                    use_fine=bool(sm.fine_sampling and step >= self.fine_start))

    def reregister_poses(self) -> None:
        """Re-run PnP for all active views against scene-NeRF depth.

        Activation-time PnP against the deformable probe SDF injects per-view
        translation error (probe-scale ambiguity). Once the scene NeRF's depth
        is sharp, one re-PnP against it snaps every pose back into the common
        gauge; the refinement params restart from zero and the pose optimizer
        keeps polishing. Each view is solved independently against the fixed
        current scene (anchors = depth under the neighbour's current pose): a
        chained solve would re-accumulate drift along the chain.
        """
        cfg = self.cfg
        cur = self.current_pose_host()
        Ks, scene_matches = _np(self.Ks), _np(self.scene_matches)
        poses_pnp = _np(self.poses_pnp).copy()
        poses_pnp[0] = cur[0]
        for i in range(1, self.n_active):
            prev = i - 1
            solved = pnp_mod.pnp_from_scene_depth(
                self.scene_params, cfg.scene_model, scene_matches[i], Ks[i], cur[prev],
                depth_range=(self.data.near, self.data.far), **self._render_state(self.global_step))
            # pnp_from_scene_depth falls back to the neighbour's pose on
            # failure; in that case keep view i's own current pose instead
            poses_pnp[i] = cur[i] if np.allclose(solved, cur[prev]) else solved
        self._set_poses(poses_pnp, zero_refine=self.n_active)

    def _ba_steps(self) -> tuple:
        return tuple(int(r * self.cfg.scene_model.max_iter) for r in self.cfg.camera.ba_at_ratios)

    def update_plastic_chord_k(self) -> None:
        """Re-bound the plastic-phase chord K for the current poses.

        The init-time bound (GT + PnP seeds + margin) is not invariant under
        training: an activation warmup can accept a pose with a large transient
        translation excursion, moving a camera close enough that its in-box
        chords exceed K -- far samples then silently truncate, the probe's far
        side starves, and the mask and render losses carve the SDF empty.
        Called from every host pose event; K only grows and is capped by the
        dense budget."""
        om = self.cfg.object_model
        if not om.use_maskcache or self._k_phase is None:
            return
        if self.global_step > self.cfg.object_train.N_iters:
            return
        poses = np.concatenate([_np(self.poses_gt), self.current_pose_host()], axis=0)
        Ks = np.concatenate([_np(self.Ks)] * 2, axis=0)
        k = min(om.n_samples, maskcache.max_inbbox_lanes(
            poses, Ks, self.H, self.W, om.xyz_min_np, om.xyz_max_np, om.stepsize * om.voxel_size))
        if k > self._k_phase:
            print(f"[maskcache {self.global_step}] plastic chord K {self._k_phase} -> {k} "
                  f"(pose drift re-bound)")
            self._k_phase = k
            if self._mask_k is not None:
                self._mask_k = k

    def check_probe_health(self) -> dict:
        """End-of-object-phase probe invariant (see `ProbeHealthError`).

        Fires once when the host loop crosses object_train.N_iters; returns
        the measured raw-grid stats and raises `ProbeHealthError` on the
        evaporation / filled-box signatures unless
        cfg.object_train.probe_health_check is off."""
        raw = _np(self.obj_params["sdf_grid"])
        n_neg = int((raw < 0).sum())
        frac_neg = float(n_neg) / raw.size
        beta = float(object_sdf.softplus10(self.obj_params["sdf_beta"]))
        stats = {"frac_neg": frac_neg, "n_neg": n_neg, "map_beta": beta,
                 "raw_min": float(raw.min()), "raw_max": float(raw.max())}
        evaporated = n_neg < 8 or frac_neg < 1e-4
        filled = frac_neg > 0.98
        stats["healthy"] = not (evaporated or filled)
        if stats["healthy"] or not self.cfg.object_train.probe_health_check:
            if not stats["healthy"]:
                print(f"[trainer] WARNING probe health check disabled but probe is unhealthy: {stats}")
            return stats
        kind = ("EVAPORATED (no negative SDF voxels -> no interior, PnP anchors come from nothing)"
                if evaporated else
                "FILLED BOX (negative out to the bbox faces -> mesh extraction empty)")
        raise ProbeHealthError(
            f"object probe {kind} at the end of the object phase (step {self.global_step}): {stats}. "
            "A run without a live probe must not count as a pass. For the filled-box basin try "
            "weight_shell=1.0, shell_margin=0.05; healthy dynamics collapse map_beta to ~0.01-0.5 "
            "within ~300 steps (map_beta > ~2 with frac_neg draining is the collapse signature). "
            "Disable only for probe-less experiments via object_train.probe_health_check=False.")

    def _ba_observations(self, n_act: int):
        """Match packs -> BA observations for the active views (chain scene +
        object pairs plus (i-2, i) skip pairs)."""
        scene_matches, obj_matches = _np(self.scene_matches), _np(self.obj_matches)
        packs, pairs = [], []
        for i in range(1, self.n_train):
            j = int(self.pair_j[i])
            packs += [scene_matches[i], obj_matches[i]]
            pairs += [(j, i), (j, i)]
        if self.data.ba_matches is not None and len(self.data.ba_matches):
            for pack, ab in zip(self.data.ba_matches, self.data.ba_pairs):
                packs.append(np.asarray(pack))
                pairs.append((int(ab[0]), int(ab[1])))
        return ba_mod.observations_from_packs(packs, pairs, n_act)

    def polish_poses_ba(self) -> dict:
        """Match-based bundle-adjustment pose polish (host event).

        See `pose_init/ba.py`: triangulate the load-time match packs from the
        current poses, LM-refine every non-anchor active view, write the
        polished poses into `poses_pnp`, and restart the refinement rows from
        zero (the `reregister_poses` handoff). Unlike scene-depth
        re-registration, the matches cannot co-adapt to wrong poses. Without
        OpenCV the polish declines and the poses stay."""
        n_act = self.n_active
        obs = self._ba_observations(n_act)
        cur = self.current_pose_host()
        polished, info = ba_mod.polish_poses_matches(cur[:n_act], _np(self.Ks)[:n_act], obs,
                                                     fix_first=self.fix_first_pose)
        if not info["applied"]:
            print(f"[ba {self.global_step}] polish skipped: {info}")
            return info
        poses_pnp = _np(self.poses_pnp).copy()
        poses_pnp[:n_act] = polished
        self._set_poses(poses_pnp, zero_refine=n_act)
        moved = float(np.abs(polished - cur[:n_act]).max())
        print(f"[ba {self.global_step}] polished {n_act} poses from {len(obs)} pair packs: med reproj "
              f"{info['med_reproj_px']:.2f} px, {info['rounds']} rounds, max pose delta {moved:.4f}")
        return info

    def maybe_activate_view(self, step: int) -> None:
        """Incremental activation + PnP of the newly added view (host event)."""
        cfg = self.cfg
        cam = cfg.camera
        if not cam.incremental or self.n_active >= self.n_train:
            return
        if step == 0 or step % cam.incremental_step != 0:
            return
        new_idx = self.n_active  # next train view
        cur = self.current_pose_host()
        Ks, obj_matches, scene_matches = _np(self.Ks), _np(self.obj_matches), _np(self.scene_matches)
        depth_range = (self.data.near, self.data.far)
        rstate = self._render_state(step)
        pnp_mod.LAST_QUALITY = None  # refreshed by solve_pnp below
        if cfg.pnp.use_identical:
            new_pose = cur[new_idx - 1]
        elif cfg.pnp.use_pnp and cfg.pnp.anchor == "scene":
            # scene-gauge anchors: depth rendered by the scene branch at the
            # previous view's match pixels (avoids the probe-scale ambiguity)
            new_pose = pnp_mod.pnp_from_scene_depth(
                self.scene_params, cfg.scene_model, scene_matches[new_idx], Ks[new_idx],
                cur[new_idx - 1], depth_range=depth_range, **rstate)
        elif cfg.pnp.use_pnp and cfg.pnp.anchor == "object_scaled":
            # probe anchors with one median scene/probe depth-ratio rescale
            new_pose = pnp_mod.pnp_from_matches_scalefixed(
                self.obj_params, cfg.object_model, obj_matches[new_idx], Ks[new_idx],
                cur[new_idx - 1], inverse_y=self.data.inverse_y, near=self.data.near,
                far=self.data.far, scene_params=self.scene_params, scene_cfg=cfg.scene_model, **rstate)
        elif cfg.pnp.use_pnp:
            new_pose = pnp_mod.pnp_from_matches(
                self.obj_params, cfg.object_model, obj_matches[new_idx], Ks[new_idx],
                cur[new_idx - 1], inverse_y=self.data.inverse_y, near=self.data.near,
                far=self.data.far, extra_packs=[scene_matches[new_idx]])
        else:
            # no-PnP protocols seed from poses_pnp = noise o GT
            new_pose = _np(self.poses_pnp[new_idx])
        q = pnp_mod.LAST_QUALITY
        if q is not None:
            qtag = (f"pnp med_reproj {q['med_reproj_px']:.1f}px n {q['n_pts']}"
                    f"{' FALLBACK' if q.get('fallback') else ''}")
        elif cfg.pnp.use_identical:
            qtag = "seed (prev view)"
        elif cfg.pnp.use_pnp:
            qtag = "pnp (no-ransac)"
        else:
            qtag = "seed (gt+noise)" if cam.noise else "seed (gt)"
        # pre-warmup/rescue: the anchor-scale-true start for the match refinement below
        pnp_pose0 = np.asarray(new_pose).copy()
        self._log_activation_error(step, new_idx, cur, new_pose, qtag)

        gate = cam.activation_warmup_gate_px
        photo_ratio = cam.activation_warmup_photo_ratio
        holdout_gate = cam.activation_warmup_holdout_px

        def photo_score(pose, idx):
            return evaluator.photometric_pose_score(
                self.scene_params, cfg.scene_model, pose, self.Ks[idx], self.images[idx],
                depth_range, **rstate)

        def warmup(pose, **kw):
            return _np(evaluator.test_time_pose_optim(
                self.scene_params, cfg.scene_model, pose, self.Ks[new_idx], self.images[new_idx],
                depth_range, n_iters=cam.activation_pose_warmup, lr=cam.activation_warmup_lr,
                rand_rays=min(1024, self.H * self.W),
                center_anchor=cam.activation_warmup_center_anchor, **rstate, **kw))

        # warmup gate: a PnP pose that already reprojects tightly is better
        # than anything a blurry early-BARF render can align
        do_warmup = cam.activation_pose_warmup > 0
        if do_warmup and gate > 0 and q is not None and not q.get("fallback", False) \
                and q["med_reproj_px"] <= gate:
            skip_msg = f"PnP med reproj {q['med_reproj_px']:.1f}px <= gate {gate:g}px"
            do_warmup = False
            hold = q.get("holdout_reproj_px", 0.0)
            if holdout_gate > 0 and hold > holdout_gate:
                # geometric second opinion: the solve fits its own anchors
                # but does not generalize across a holdout split -> degenerate
                do_warmup = True
                print(f"[activate {step}] view {new_idx}: holdout gate re-arms warmup "
                      f"(xval reproj {hold:.1f}px > {holdout_gate:g}px)")
            elif holdout_gate > 0:
                skip_msg += f", holdout {hold:.1f}px <= {holdout_gate:g}px"
            if not do_warmup and photo_ratio > 0:
                # photometric second opinion: a degenerate PnP solve reprojects
                # tightly but renders wrong -- compare the new view's fixed-ray
                # MSE against the previous, already-trained view as the scale
                # for "consistent with the scene"
                s_new = photo_score(new_pose, new_idx)
                s_ref = photo_score(cur[new_idx - 1], new_idx - 1)
                if s_new > photo_ratio * max(s_ref, 1e-8):
                    do_warmup = True
                    print(f"[activate {step}] view {new_idx}: photo gate re-arms warmup "
                          f"(mse {s_new:.4f} > {photo_ratio:g}x ref {s_ref:.4f})")
                else:
                    skip_msg += f", photo mse {s_new:.4f} <= {photo_ratio:g}x ref {s_ref:.4f}"
            if not do_warmup:
                print(f"[activate {step}] view {new_idx}: warmup skipped ({skip_msg})")
        if do_warmup:
            # photometric warmup: align the new view against the current
            # scene before the joint loss sees it (cuts the PnP t-injection)
            warm_pose = warmup(new_pose, rot_only=cam.activation_warmup_rot_only)
            if photo_ratio > 0 or holdout_gate > 0:
                # guarded: only accept the warmup if it scores better on the
                # same fixed rays (the early-BARF render can be too blurry to
                # align against, degrading good PnP poses)
                s_pnp = photo_score(new_pose, new_idx)
                s_warm = photo_score(warm_pose, new_idx)
                accept = s_warm <= s_pnp
                why = f"mse pnp {s_pnp:.4f} -> warm {s_warm:.4f}"
                mg = cam.activation_warmup_match_guard
                if accept and mg > 0 and q is not None and "world_pts" in q:
                    # match-anchor guard: the photometric score can prefer a
                    # corrupted pose; the activation's own PnP anchors are the
                    # co-adaptation-free referee
                    med_warm = pnp_mod.reproj_for_pose(q, warm_pose)
                    lim = max(mg * max(q["med_reproj_px"], 0.5), cam.match_guard_px_floor)
                    if med_warm > lim:
                        accept = False
                        why += (f"; match guard REJECTS: warm reproj {med_warm:.1f}px > {lim:.1f}px "
                                f"(pnp {q['med_reproj_px']:.1f}px)")
                    else:
                        why += f", warm reproj {med_warm:.1f}px <= {lim:.1f}px"
                if accept:
                    new_pose = warm_pose
                print(f"[activate {step}] view {new_idx}: warmup "
                      f"{'accepted' if accept else 'REJECTED'} ({why})")
            else:
                new_pose = warm_pose
            self._log_activation_error(step, new_idx, cur, new_pose, "warmup")
        rescue_ratio = cam.activation_rescue_ratio
        if rescue_ratio > 0:
            # catastrophic-PnP rescue: a degenerate RANSAC solve can land far
            # outside the warmup's basin -- if the settled pose still renders
            # much worse than the previous trained view, restart from that
            # view's pose
            s_final = photo_score(new_pose, new_idx)
            s_ref = photo_score(cur[new_idx - 1], new_idx - 1)
            if s_final > rescue_ratio * max(s_ref, 1e-8):
                prev_pose = np.asarray(cur[new_idx - 1])
                cands = [(s_final, new_pose, "kept"),
                         (photo_score(prev_pose, new_idx), prev_pose, "prev")]
                if cam.activation_pose_warmup > 0:
                    # full-SE3 warmup: consecutive views differ in both R and
                    # t, so the rot-only constraint does not apply here
                    warm_prev = warmup(prev_pose)
                    cands.append((photo_score(warm_prev, new_idx), warm_prev, "warm-prev"))
                s_best, new_pose, tag = min(cands, key=lambda c: c[0])
                print(f"[activate {step}] view {new_idx}: rescue tournament (mse {s_final:.4f} > "
                      f"{rescue_ratio:g}x ref {s_ref:.4f}) -> {tag} (mse {s_best:.4f})")
                if tag != "kept":
                    self._log_activation_error(step, new_idx, cur, new_pose, f"rescue:{tag}")
        mr_gate = cam.activation_match_refine_px
        if mr_gate > 0 and cfg.pnp.use_pnp and not cfg.pnp.use_identical:
            # Scoped to the PnP-activation regime: no-PnP protocols seed from
            # noise-composed GT and must not be silently snapped to match
            # geometry. LM over the new view's 6-dof pose on its own match
            # packs against the trusted views
            # (pose_init/ba.refine_view_matches); accepted only when the
            # converged median residual is below the gate.
            poses_now = np.asarray(cur).copy()
            poses_now[new_idx] = new_pose
            obs_act = self._ba_observations(new_idx + 1)
            # rescue-only trigger: a settled pose already consistent with the
            # packs is left alone. At weak conditioning several poses fit the
            # packs equally well, so "refining" a consistent pose can hop into
            # a wrong-but-consistent basin; refinement is for poses that are
            # measurably inconsistent (residuals in the tens of px).
            med_settled = ba_mod.view_match_med_px(poses_now, Ks, obs_act, new_idx)
            if med_settled <= mr_gate:
                print(f"[activate {step}] view {new_idx}: match refine skipped (settled pose "
                      f"consistent, med {med_settled:.2f}px <= {mr_gate:g}px)")
                obs_act = []  # fall through without refining
            # start order matters (strict-improvement tie-break in ba.py): the
            # raw PnP pose first -- its anchors pin the translation scale along
            # the narrow-baseline near-null direction where several basins
            # converge to ~equal match cost
            refined, mr = ba_mod.refine_view_matches(
                poses_now, Ks, obs_act, new_idx,
                starts=[("pnp", pnp_pose0), ("settled", new_pose),
                        ("prev", np.asarray(cur[new_idx - 1]))])
            if mr["applied"] and mr["med_px"] <= mr_gate:
                moved = float(np.abs(refined - new_pose).max())
                new_pose = refined
                print(f"[activate {step}] view {new_idx}: match refine accepted (start {mr['start']}, "
                      f"med {mr['med_px']:.2f}px <= {mr_gate:g}px, max delta {moved:.4f})")
                self._log_activation_error(step, new_idx, cur, new_pose, "match-refine")
            elif mr["applied"]:
                print(f"[activate {step}] view {new_idx}: match refine declined "
                      f"(med {mr['med_px']:.2f}px > {mr_gate:g}px)")
        poses_pnp = _np(self.poses_pnp).copy()
        poses_pnp[new_idx] = new_pose
        self._set_poses(poses_pnp)
        self.n_active += 1
        # the settled pose may sit far from the init-time camera set; keep the
        # plastic-phase chord K sound for it (see update_plastic_chord_k)
        self.update_plastic_chord_k()

    def _log_activation_error(self, step, new_idx, cur, new_pose, tag) -> None:
        """Print the activated view's relative pose error against GT
        (gauge-free): the solved (new o prev^-1) against GT's, which isolates
        this activation's error from global gauge drift. Host-only."""
        def rel(a, b):  # a o b^{-1}
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
            R = a[:, :3] @ b[:, :3].T
            return R, a[:, 3] - R @ b[:, 3]

        gt = _np(self.poses_gt)
        R_s, t_s = rel(new_pose, cur[new_idx - 1])
        R_g, t_g = rel(gt[new_idx], gt[new_idx - 1])
        fro = np.linalg.norm(R_s - R_g)
        dR = np.degrees(2.0 * np.arcsin(np.clip(fro / (2.0 * np.sqrt(2.0)), 0.0, 1.0)))
        dt = float(np.linalg.norm(t_s - t_g)) * 100.0
        print(f"[activate {step}] view {new_idx} ({tag}): rel-pose error R {dR:.2f}deg t {dt:.2f}")

    def _host_events(self, step: int) -> None:
        """The host events before `step`, in the reference's order."""
        ot, cam = self.cfg.object_train, self.cfg.camera
        if not self._probe_checked and 0 < ot.N_iters <= step:
            # one-shot, set before the raise: a caller that catches the
            # error can resume without raising again at each step
            self._probe_checked = True
            self.check_probe_health()
        self.maybe_activate_view(step)
        self.maybe_pg_scale(step)
        if step == self._rereg_step() and step > 0:
            self.reregister_poses()
        if step > 0 and step in self._ba_steps():
            self.polish_poses_ba()
        if (self.cfg.object_model.use_maskcache and step > 0
                and step <= ot.N_iters + ot.maskcache_update_every
                and step % ot.maskcache_update_every == 0):
            self.refresh_maskcache()

    def _rereg_step(self) -> int:
        ratio = self.cfg.camera.reregister_at_ratio
        return int(ratio * self.cfg.scene_model.max_iter) if ratio is not None else -1

    def _next_boundary(self, step: int) -> int:
        """First step > `step` at which a host event fires or a phase flag
        flips (the reference's candidates)."""
        cfg, ot = self.cfg, self.cfg.object_train
        cands = [super()._next_boundary(step), ot.N_iters + 1]     # object_on flips off
        if cfg.camera.incremental and self.n_active < self.n_train:
            inc = cfg.camera.incremental_step
            cands.append(((step // inc) + 1) * inc)                 # maybe_activate_view
        cands += [s for s in self._pg_scale if s > step]            # maybe_pg_scale
        if cfg.camera.reregister_at_ratio is not None:
            cands.append(self._rereg_step())                        # reregister_poses
        cands += [s for s in self._ba_steps() if s > step]          # polish_poses_ba
        if cfg.object_model.use_maskcache and step <= ot.N_iters + ot.maskcache_update_every:
            upd = ot.maskcache_update_every
            cands.append(((step // upd) + 1) * upd)                 # refresh_maskcache
        return min(c for c in cands if c > step)


def tv_weights(ot, step: torch.Tensor) -> tuple:
    """(sdf_tv, smooth_grad_tv) that the `tv_updates` schedule has reached by
    `step`, as float32 tensors."""
    sdf_tv = torch.full_like(step, ot.sdf_tv, dtype=torch.float32)
    smooth_tv = torch.full_like(step, ot.smooth_grad_tv, dtype=torch.float32)
    for ev_step, updates in ot.tv_updates:
        upd = dict(updates)
        if "sdf_tv" in upd:
            sdf_tv = torch.where(step >= ev_step, upd["sdf_tv"], sdf_tv)
        if "smooth_grad_tv" in upd:
            smooth_tv = torch.where(step >= ev_step, upd["smooth_grad_tv"], smooth_tv)
    return sdf_tv, smooth_tv


def _leafify(tree):
    """Fresh autograd leaves sharing the params' storage."""
    return tree_unflatten(tree, [t.detach().requires_grad_(True) for t in tree_leaves(tree)])


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


def build_trainer(small: bool = False, device="cuda", matmul_dtype: str = "bfloat16",
                  mesh=None) -> JointTrainer:
    """bench.py's `build_trainer` workload: the joint trainer, starting in the
    early phase (object + scene); with `mesh`, ray data-parallel over its ranks."""
    cfg, data = _bench_workload(small, matmul_dtype)
    return JointTrainer(cfg, data, device=device, mesh=mesh)
