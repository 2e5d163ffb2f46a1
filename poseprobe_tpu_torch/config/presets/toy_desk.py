"""Toy desk scene — mirror of `configs/toy/desk1.py` (smallest real workload)."""
from .. import config as cfg_mod
from ...models.object_sdf import ObjectConfig
from ...models.scene_nerf import SceneConfig

_XYZ_MIN = (0.04 * 3, -0.01 * 3, 0.12 * 3)
_XYZ_MAX = (0.07 * 3, 0.015 * 3, 0.15 * 3)


def _expanded_bbox(scale=1.25):
    lo, hi = _XYZ_MIN, _XYZ_MAX
    shift = [(b - a) * (scale - 1) / 2 for a, b in zip(lo, hi)]
    return (tuple(a - s for a, s in zip(lo, shift)),
            tuple(b + s for b, s in zip(hi, shift)))


def get_config(datadir: str = "./data/toy_desk") -> cfg_mod.ExperimentConfig:
    lo, hi = _expanded_bbox(1.25)
    return cfg_mod.ExperimentConfig(
        expname="our_desk_1",
        basedir="./logs/toy",
        data=cfg_mod.DataConfig(
            datadir=datadir, dataset_type="toy", selected_id=(51, 54, 55),
            test_id=tuple(range(100)), inverse_y=True, white_bkgd=False,
            near=0.3, far=2.0, xyz_min=_XYZ_MIN, xyz_max=_XYZ_MAX,
        ),
        camera=cfg_mod.CameraConfig(noise=0.0, barf_c2f=(0.6, 1.0),
                                    incremental=True, incremental_step=1),
        pnp=cfg_mod.PnPConfig(use_pnp=False, ransac=False),
        world_bound_scale=1.25,
        object_model=ObjectConfig(
            xyz_min=lo, xyz_max=hi, num_voxels=96**3, num_voxels_base=96**3,
            barf_c2f=(0.6, 1.0), N_iters=12000, world_bound_scale=1.25,
            s_ratio=50.0, s_start=0.2,
        ),
        object_train=cfg_mod.ObjectTrainConfig(
            N_iters=12000, N_rand=1024, weight_tv_k0=0.0, weight_tv_density=0.005,
            projection_dis_error=0.001, weight_near_surface=0.1,
            lr_pose=0.0, lr_pose_end=0.0,
        ),
        scene_model=SceneConfig(barf_c2f=(0.4, 0.7), max_iter=60000,
                                ratio_start_fine_sampling_at_x=0.3),
        scene_train=cfg_mod.SceneTrainConfig(max_iter=60000),
    )
