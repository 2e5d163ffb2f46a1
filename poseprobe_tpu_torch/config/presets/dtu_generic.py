"""Generic DTU, any scan — mirror of `configs/dtu_e2e/coarse.py`.

Differences vs the scan1 preset (`configs/dtu_e2e/scan1.py`): pose noise 0.15,
15k object iterations, VGG surface-feature loss on (weight 0.001), object-side
pose lr 1e-3, weight_tv_k0 = 0. Scan id parameterizes expname and the seed
(`define_trainer.py:62-63`).
"""
from .. import config as cfg_mod
from ...models.object_sdf import ObjectConfig
from ...models.scene_nerf import SceneConfig


def get_config(datadir: str = "./data/DTU", scan_id: int = 2,
               selected_id: tuple = (22, 25, 28)) -> cfg_mod.ExperimentConfig:
    return cfg_mod.ExperimentConfig(
        expname=f"scan{scan_id}",
        basedir="./logs/dtu",
        seed=scan_id,  # DTU seed = scan id (define_trainer.py:62-63)
        data=cfg_mod.DataConfig(
            datadir=datadir, dataset_type="dtu", selected_id=tuple(selected_id),
            inverse_y=True, white_bkgd=False, near=0.3, far=4.0,
            xyz_min=(-0.4, -0.4, -0.5), xyz_max=(0.4, 0.4, 0.3),
            max_keypoints=512, max_matcher=256, match_threshold=0.2,
            trainskip=10,
        ),
        # coarse.py:36-41 — noisy-pose regime with PnP refinement
        camera=cfg_mod.CameraConfig(noise=0.15, barf_c2f=(0.6, 1.0),
                                    incremental=True, incremental_step=800,
                                    # the reference's activation recipe:
                                    # guarded photometric warmup +
                                    # catastrophic-PnP rescue
                                    activation_pose_warmup=100,
                                    activation_warmup_gate_px=8.0,
                                    activation_warmup_photo_ratio=4.0,
                                    activation_rescue_ratio=10.0),
        pnp=cfg_mod.PnPConfig(use_pnp=True, ransac=True),
        world_bound_scale=1.5,
        object_model=ObjectConfig(
            xyz_min=(-0.6, -0.6, -0.75), xyz_max=(0.6, 0.6, 0.45),
            num_voxels=96**3, num_voxels_base=96**3,
            rgbnet_dim=12, rgbnet_depth=4, rgbnet_width=128,
            posbase_pe=5, viewbase_pe=1, geo_rgb_dim=3,
            s_ratio=50.0, s_start=0.2, stepsize=1.5,
            barf_c2f=(0.6, 1.0), N_iters=15000,          # coarse.py:56
            smooth_ksize=0, smooth_sigma=0.8, world_bound_scale=1.5,
            # free-space skipping (the reference's MaskCache)
            use_maskcache=True, maskcache_thres=0.1, maskcache_keep=0.5,
        ),
        object_train=cfg_mod.ObjectTrainConfig(
            N_iters=15000, N_rand=1024, lrate_decay=10,
            lrate_sdf=0.1, lrate_k0=0.1, lrate_rgbnet=1e-3, lrate_warpnet=1e-3,
            lrate_sdf_alpha=1e-2, lrate_sdf_beta=1e-2,
            weight_tv_k0=0.0, weight_tv_density=0.005,     # coarse.py:59-60
            sdf_tv=0.1, smooth_grad_tv=0.05,
            tv_updates=((4000, (("sdf_tv", 0.1), ("smooth_grad_tv", 0.2))),),
            decay_step_module=((5000, (("sdf", 0.1), ("sdf_beta", 0.1), ("sdf_alpha", 0.1))),
                               (10000, (("sdf", 0.5), ("sdf_beta", 0.5), ("sdf_alpha", 0.5)))),
            weight_surface_projection=0.001,               # coarse.py:52
            projection_dis_error=0.001, weight_near_surface=0.1,
            lr_pose=1e-3, lr_pose_end=1e-4,                # coarse.py:75-76
            # progressive grid scaling, fine_train-style schedule
            # (`configs/default_fine_s.py:70`; note the live surf_train
            # template disables it at :78 — enabled here as the DVGO-standard
            # coarse-to-fine warmup): start at 96^3/8, double the voxel count
            # at each checkpoint, full resolution by 3k steps
            pg_scale=(1000, 2000, 3000),
            # free-space skipping: rebuild the occupancy mask from the live
            # SDF every 1000 steps (reference MaskCache analog, `grid.py:212`)
            maskcache_update_every=1000,
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
            loss_weight=(("render", 0.0), ("corres", -2.0), ("depth_cons", -3.0),
                         ("depth_patch", -2.0), ("fea_cons", None), ("fg_mask", None),
                         ("distortion", None)),
            start_ratio_depth_cons=0.3,
            gradually_decrease_corres_weight=True,
            corres_weight_reduct_at_x_iter=5000,
        ),
    )
