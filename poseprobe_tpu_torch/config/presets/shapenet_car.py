"""ShapeNet-car-in-scene, 3 views — mirror of `configs/nerf_synthetic_e2e/desk_car.py`.

A synthetic scene with a ShapeNet car as the pose probe: white background,
GT-seeded poses (no PnP), VGG surface-feature loss on, 15k object iterations.
"""
from .. import config as cfg_mod
from ...models.object_sdf import ObjectConfig
from ...models.scene_nerf import SceneConfig

_XYZ_MIN = (-0.25, -0.2, -0.5)   # desk_car.py:33
_XYZ_MAX = (0.25, 0.4, 0.3)


def _expanded(scale=1.5):
    shift = [(b - a) * (scale - 1) / 2 for a, b in zip(_XYZ_MIN, _XYZ_MAX)]
    return (tuple(a - s for a, s in zip(_XYZ_MIN, shift)),
            tuple(b + s for b, s in zip(_XYZ_MAX, shift)))


def get_config(datadir: str = "./data/scene_with_shape/02958343") -> cfg_mod.ExperimentConfig:
    lo, hi = _expanded(1.5)
    return cfg_mod.ExperimentConfig(
        expname="desk_car",
        basedir="./logs/nerf_synthetic",
        data=cfg_mod.DataConfig(
            datadir=datadir, dataset_type="scene_with_shapenet",
            selected_id=(80, 95, 10),                  # desk_car.py:14
            inverse_y=True, white_bkgd=True, near=0.2, far=3.0,
            xyz_min=_XYZ_MIN, xyz_max=_XYZ_MAX,
            max_keypoints=512, max_matcher=256, match_threshold=0.2,
        ),
        camera=cfg_mod.CameraConfig(noise=0.0, barf_c2f=(0.6, 1.0),
                                    incremental=True, incremental_step=800),
        pnp=cfg_mod.PnPConfig(use_pnp=False, ransac=True),
        world_bound_scale=1.5,
        object_model=ObjectConfig(
            xyz_min=lo, xyz_max=hi, num_voxels=96**3, num_voxels_base=96**3,
            rgbnet_dim=12, rgbnet_depth=4, rgbnet_width=128,
            posbase_pe=5, viewbase_pe=1, geo_rgb_dim=3,
            s_ratio=50.0, s_start=0.2,
            barf_c2f=(0.6, 1.0), N_iters=15000,        # desk_car.py:59
            world_bound_scale=1.5,
        ),
        object_train=cfg_mod.ObjectTrainConfig(
            N_iters=15000, N_rand=1024, lrate_decay=10,
            weight_tv_k0=0.0, weight_tv_density=0.005,
            sdf_tv=0.1, smooth_grad_tv=0.05,
            tv_updates=((4000, (("sdf_tv", 0.1), ("smooth_grad_tv", 0.2))),),
            decay_step_module=((5000, (("sdf", 0.1), ("sdf_beta", 0.1), ("sdf_alpha", 0.1))),
                               (10000, (("sdf", 0.5), ("sdf_beta", 0.5), ("sdf_alpha", 0.5)))),
            weight_surface_projection=0.001,           # desk_car.py:53
            projection_dis_error=0.001, weight_near_surface=0.1,
            lr_pose=0.0, lr_pose_end=0.0,
        ),
        scene_model=SceneConfig(
            barf_c2f=(0.4, 0.7), sample_intvs=128, sample_intvs_fine=128,
            fine_sampling=True, depth_param="metric", rand_rays=1024,
            max_iter=60000, ratio_start_fine_sampling_at_x=0.3,
            matmul_dtype="bfloat16",
        ),
        scene_train=cfg_mod.SceneTrainConfig(
            max_iter=60000, lr=5e-4, lr_end=1e-4, lr_pose=1e-3, lr_pose_end=1e-4,
            ratio_end_joint_nerf_pose_refinement=0.3,
            start_ratio_depth_cons=0.3,
            gradually_decrease_corres_weight=True,
            corres_weight_reduct_at_x_iter=5000,
        ),
    )
