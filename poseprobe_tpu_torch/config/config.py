"""Experiment configuration: the dataclasses the ported training step reads.

Port of `poseprobe_tpu/config/config.py`, cut to the fields the joint
training step, its trainer and the trainer's host pose events read; every
field keeps the reference's name and default. The data block holds only what
the ported slices use (loaders come later).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..models.object_sdf import ObjectConfig
from ..models.scene_nerf import SceneConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    near: float = 0.3
    far: float = 4.0


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    noise: float = 0.0
    barf_c2f: Optional[tuple] = (0.6, 1.0)   # object-branch c2f window
    incremental: bool = True
    incremental_step: int = 800
    # gauge anchor: None = fixed in PnP mode, free in noisy-GT mode
    fix_first_pose: Optional[bool] = None
    # mid-training re-registration (None = off): at step = ratio * max_iter,
    # re-run PnP for every view i >= 1 against depth rendered by the scene NeRF
    # at the previous view's match pixels, replacing poses_pnp and zeroing the
    # refinement rows
    reregister_at_ratio: Optional[float] = None
    # activation-time pose warmup (0 = off): after PnP-initialising a newly
    # activated view, run this many photometric pose-only Adam steps against
    # the current scene before joint training touches the view
    activation_pose_warmup: int = 0
    activation_warmup_lr: float = 3e-3
    # gate the warmup on PnP's own quality: when > 0, the warmup only runs if
    # the PnP median reprojection error (px) exceeds this value (or PnP fell
    # back); a warmup against a blurry early render degrades already-good PnP
    # poses while rescuing bad ones. 0 = the warmup always runs.
    activation_warmup_gate_px: float = 0.0
    # photometric second opinion on the px gate (0 = off): a gate-skipped
    # warmup is re-armed if the new view's fixed-ray photometric MSE exceeds
    # `ratio * MSE(previous, already-trained view)`. Whenever the warmup runs,
    # its result is only accepted if it scores better than the PnP pose on the
    # same fixed rays (guarded warmup).
    activation_warmup_photo_ratio: float = 0.0
    # geometric second opinion (0 = off): re-arm a gate-skipped warmup when
    # PnP's holdout cross-validation error (pnp._holdout_reproj) exceeds this
    # many px; it never fires on well-constrained solves
    activation_warmup_holdout_px: float = 0.0
    # match-anchor acceptance guard on the warmup result (default on): accept
    # a photometrically better warmup pose only if its median reprojection
    # over the activation's own PnP anchors stays within
    # max(this_ratio x med_pnp, match_guard_px_floor). The photometric score
    # can prefer a corrupted pose; the match geometry cannot co-adapt.
    # 0 disables.
    activation_warmup_match_guard: float = 3.0
    match_guard_px_floor: float = 3.0
    # activation-time single-view match refinement (default on): LM over the
    # new view's 6-dof pose on its own match packs against the trusted views
    # (pose_init/ba.refine_view_matches), accepted when the converged median
    # residual <= this gate (px). 0 disables.
    activation_match_refine_px: float = 1.0
    # the warmup optimizes rotation only (keeps the camera center at PnP's)
    activation_warmup_rot_only: bool = False
    # soft camera-center anchor toward the warmup seed (PnP center); see
    # evaluator.test_time_pose_optim
    activation_warmup_center_anchor: float = 0.0
    # catastrophic-PnP rescue tournament (0 = off): after the warmup logic
    # settles on a pose, if its fixed-ray photometric MSE still exceeds
    # `ratio * MSE(previous, already-trained view)`, fall back to candidates
    # anchored at the previous view's pose (raw + full-SE3 warmup) and keep
    # the photometric argmin
    activation_rescue_ratio: float = 0.0
    # match-based bundle-adjustment pose polish (pose_init/ba.py; () = off):
    # at each step = ratio * max_iter, triangulate the load-time match packs
    # from the current poses and LM-refine every non-anchor view against them
    ba_at_ratios: tuple = ()


@dataclasses.dataclass(frozen=True)
class PnPConfig:
    use_pnp: bool = True
    use_identical: bool = False
    ransac: bool = True
    # 3D-anchor source for activation-time PnP: "object" = probe-SDF surface
    # query; "scene" = depth rendered by the scene NeRF at the previous view's
    # match pixels (same gauge as the already-calibrated poses);
    # "object_scaled" = probe anchors with their camera distances rescaled by
    # the median scene-depth / probe-depth ratio
    anchor: str = "object"


@dataclasses.dataclass(frozen=True)
class ObjectTrainConfig:
    """Object-branch training block."""

    N_iters: int = 10000
    N_rand: int = 1024
    lrate_decay: int = 10               # lr *= 0.1^(1/(decay*1000)) per step
    # per-module learning rates; 0 => frozen
    lrate_sdf: float = 0.1
    lrate_k0: float = 0.1
    lrate_rgbnet: float = 1e-3
    lrate_warpnet: float = 1e-3
    lrate_sdf_alpha: float = 1e-2
    lrate_sdf_beta: float = 1e-2
    # staged multiplicative lr drops
    decay_step_module: tuple = ((5000, (("sdf", 0.1), ("sdf_beta", 0.1), ("sdf_alpha", 0.1))),
                                (10000, (("sdf", 0.5), ("sdf_beta", 0.5), ("sdf_alpha", 0.5))))
    # loss weights
    weight_main: float = 1.0
    weight_mask: float = 0.1
    weight_tv_k0: float = 0.01
    weight_tv_density: float = 0.005
    sdf_tv: float = 0.1
    smooth_grad_tv: float = 0.05
    tv_updates: tuple = ((4000, (("sdf_tv", 0.1), ("smooth_grad_tv", 0.2))),)
    weight_surface_projection: float = 0.0   # > 0 is not ported (needs VGG feature maps)
    projection_dis_error: float = 0.001
    weight_near_surface: float = 0.1
    # deform-prior dynamic weight endpoints, exp-decayed over the object phase
    weight_deform_prior_init: float = 1e-1
    weight_deform_prior_final: float = 1e-3
    # progressive grid scaling checkpoints: training starts at
    # num_voxels / 2^len(pg_scale) and doubles the voxel count at each step listed
    pg_scale: tuple = ()
    # boundary-shell SDF positivity prior
    weight_shell: float = 0.0
    shell_margin: float = 0.0
    # free-space-skip mask refresh cadence (steps)
    maskcache_update_every: int = 1000
    # pose optimizer (0 => poses frozen)
    lr_pose: float = 0.0
    lr_pose_end: float = 0.0
    ray_sampler: str = "semantic"       # 20/30/50 background/boundary/object split
    probe_health_check: bool = True     # end-of-object-phase probe invariant (trainer.check_probe_health)


@dataclasses.dataclass(frozen=True)
class SceneTrainConfig:
    max_iter: int = 60000
    lr: float = 5e-4
    lr_end: float = 1e-4
    ratio_end_joint_nerf_pose_refinement: float = 0.3
    # when set past the rotation window, the translation dims keep refining
    # until this ratio of max_iter
    ratio_end_pose_trans: Optional[float] = None
    nerf_gradient_clipping: float = 0.1     # clip by global norm
    precrop_iters: int = 0
    precrop_frac: float = 0.5
    depth_regu_patch_size: int = 2
    huber_photometric: bool = True
    diff_loss_type: str = "huber"
    # log10 loss weights; None disables a term
    loss_weight: tuple = (("render", 0.0), ("corres", -2.0), ("depth_cons", -3.0),
                          ("depth_patch", -2.0), ("fea_cons", None), ("fg_mask", None),
                          ("distortion", None))
    start_ratio_depth_cons: Optional[float] = 0.3
    gradually_decrease_corres_weight: bool = True
    iter_start_decrease_corres_weight: int = 0
    corres_weight_reduct_at_x_iter: int = 5000
    # scene ray-sampler fractions: fg-mask wins over center when both set
    sampled_fraction_in_center: float = 0.0
    sample_fraction_in_fg_mask: float = 0.0

    def loss_weight_dict(self) -> dict:
        return dict(self.loss_weight)


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    data: DataConfig = DataConfig()
    camera: CameraConfig = CameraConfig()
    pnp: PnPConfig = PnPConfig()
    object_model: ObjectConfig = ObjectConfig()
    object_train: ObjectTrainConfig = ObjectTrainConfig()
    scene_model: SceneConfig = SceneConfig()
    scene_train: SceneTrainConfig = SceneTrainConfig()
    seed: int = 0
