"""Experiment configuration: the dataclasses the ported training step reads.

Port of `poseprobe_tpu/config/config.py`, cut to the fields the joint
training step and its trainer read; every field keeps the reference's name
and default. The data, camera and PnP blocks hold only what the ported
slices use (host pose events and loaders come later).
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
    incremental: bool = True
    # gauge anchor: None = fixed in PnP mode, free in noisy-GT mode
    fix_first_pose: Optional[bool] = None


@dataclasses.dataclass(frozen=True)
class PnPConfig:
    use_pnp: bool = True
    use_identical: bool = False


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
    probe_health_check: bool = True     # read by the host-event loop (not ported yet)


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
