"""The port's early-phase joint training step held against `JointTrainer`'s.

A tiny JAX `JointTrainer` (12^3 SDF + k0 grids, 48 object rays, mask cache on;
4x32 trunk with skip 2, 16+16 samples, 64 scene rays, 32x32 images, float32
matmuls) and the port's `JointTrainer` start from the same params, poses and
Adam state (carried across with `poseprobe_tpu_torch.convert`) and take two
early-phase steps (`object_on=True`, pose refinement on) on the same draws,
rebuilt from the JAX step's keys: once with two of three views active
(`proj_use_deform=False`: the zero-crossing surface query) and once with all
views active (`proj_use_deform=True`: the rendered-depth query).

Tolerances: losses and metrics rtol 1e-4 (the object loss sums thousands of
per-sample terms through two grid lookups); Adam moments, which carry the
gradients, rtol 2e-3 with an atol of 1e-5 of the largest moment of the tree;
poses atol 1e-6. Params after Adam: an element whose first moment is at
least 1e-2 of its module's largest lands within 1e-3 lr of the reference's
(the grids' lr is 0.1), and all but 1% of all elements within 1e-2 lr --
Adam normalises each gradient element, so an element whose gradient is within
float32 noise of zero takes a visibly different step, and only the moments
hold those.

Each of the two steps is a one-step comparison: the second step starts from
the JAX state again (params, poses, Adam moments and counts, now at count 1).
With the grids' lr of 0.1 a handful of noise-gradient voxels would move by
+-0.1 the other way and flip the validity of single matches in the second
step's reprojection term, so a two-step drift of the port is not held here.

`proj_err` is held against the reference's `projection_error_loss` run op by
op on the same state, not against the jitted step's value: the unjittered
surface query puts each ray's first sample exactly on the box face, and XLA's
fused arithmetic moves some of them across the in-box test, so the jitted and
the op-by-op JAX evaluations themselves disagree on which grazing rays count
(by 11% of the term in one of these steps). The term's weight in the total is
1e-4, inside the total's tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseprobe_tpu.config import config as jcfg
from poseprobe_tpu.data.synthetic import make_synthetic_scene as j_make
from poseprobe_tpu.losses import projection as jproj
from poseprobe_tpu.models import pose_refine as jpose_refine
from poseprobe_tpu.models.object_sdf import ObjectConfig as JObjectConfig
from poseprobe_tpu.models.scene_nerf import SceneConfig as JSceneConfig
from poseprobe_tpu.train import batching as jbatch
from poseprobe_tpu.train.trainer import JointTrainer as JJointTrainer
from poseprobe_tpu_torch import convert
from poseprobe_tpu_torch.config import config as tcfg
from poseprobe_tpu_torch.data.synthetic import make_synthetic_scene as t_make
from poseprobe_tpu_torch.models.object_sdf import ObjectConfig as TObjectConfig
from poseprobe_tpu_torch.models.scene_nerf import SceneConfig as TSceneConfig
from poseprobe_tpu_torch.ops import grid as tgrid, layout as tlayout
from poseprobe_tpu_torch.train.trainer import JointTrainer as TJointTrainer, build_trainer
from test_torch_port_step import _draws_from_jax as _scene_draws_from_jax

torch.set_num_threads(1)

SM = dict(layers_feat=(32,) * 4, layers_rgb=(16, 3), skip=(2,), L_3D=4, L_view=2,
          sample_intvs=16, sample_intvs_fine=16, rand_rays=64, max_iter=100,
          fine_sampling=True, ratio_start_fine_sampling_at_x=0.3, barf_c2f=(0.1, 0.5),
          matmul_dtype="float32")
ST = dict(max_iter=100, corres_weight_reduct_at_x_iter=20)
OT = dict(N_iters=50, N_rand=48, lr_pose=1e-3, lr_pose_end=1e-4, weight_shell=0.5,
          shell_margin=0.02, tv_updates=((4, (("sdf_tv", 0.2), ("smooth_grad_tv", 0.1))),))
SCENE = dict(n_train=3, n_test=1, H=32, W=32, seed=0, n_matches=32)
LR = {"sdf_grid": 0.1, "k0_grid": 0.1, "rgbnet": 1e-3, "warpnet": 1e-3, "sdf_alpha": 1e-2,
      "sdf_beta": 1e-2, "s_val": 0.0}


def _trainers(incremental):
    cam = dict(incremental=incremental, fix_first_pose=True, noise=0.02)
    data = j_make(**SCENE)
    m = float(data.xyz_max[0])
    oc = dict(xyz_min=(-m,) * 3, xyz_max=(m,) * 3, num_voxels=12 ** 3, num_voxels_base=12 ** 3,
              N_iters=50, world_bound_scale=1.25, use_maskcache=True, barf_c2f=(0.05, 0.4))
    jc = jcfg.ExperimentConfig(
        data=jcfg.DataConfig(near=data.near, far=data.far), camera=jcfg.CameraConfig(**cam),
        pnp=jcfg.PnPConfig(use_pnp=False), object_model=JObjectConfig(**oc),
        object_train=jcfg.ObjectTrainConfig(**OT), scene_model=JSceneConfig(**SM),
        scene_train=jcfg.SceneTrainConfig(**ST))
    tdata = t_make(**SCENE)
    tc = tcfg.ExperimentConfig(
        data=tcfg.DataConfig(near=tdata.near, far=tdata.far), camera=tcfg.CameraConfig(**cam),
        pnp=tcfg.PnPConfig(use_pnp=False), object_model=TObjectConfig(**oc),
        object_train=tcfg.ObjectTrainConfig(**OT), scene_model=TSceneConfig(**SM),
        scene_train=tcfg.SceneTrainConfig(**ST))
    return JJointTrainer(jc, data), TJointTrainer(tc, tdata, device="cpu")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leave_the_init_state(jt):
    """At the init state the deformation is exactly zero and so are the k0
    grid and two of the deformation priors: their |.| terms sit on the kink,
    where the sign of a float32 rounding error decides the gradient. A small
    seeded perturbation of the deform net's last layer and of k0 moves the
    comparison off the kink."""
    rng = np.random.default_rng(5)
    obj = dict(jt.state.obj_params)
    layers = [dict(la) for la in obj["warpnet"]["layers"]]
    layers[-1] = {k: v + jnp.asarray(rng.normal(0, 2e-2, v.shape), jnp.float32)
                  for k, v in layers[-1].items()}
    obj["warpnet"] = dict(obj["warpnet"], layers=layers)
    obj["k0_grid"] = jnp.asarray(rng.normal(0, 0.1, obj["k0_grid"].shape), jnp.float32)
    jt.state.obj_params = obj


def _carry_state(jt, tt):
    st = jt.state
    tt.obj_params = convert.object_params_from_jax(_np(st.obj_params), "cpu")
    tt.scene_params = convert.scene_params_from_jax(_np(st.scene_params), "cpu")
    tt.pose_params = convert.pose_params_from_jax(_np(st.pose_params), "cpu")
    tt.poses_pnp = torch.tensor(np.asarray(st.poses_pnp))
    tt.opt_obj_state = convert.object_adam_state_from_jax(_np(st.opt_obj), "cpu")
    tt.opt_scene_state = convert.adam_state_from_jax(_np(st.opt_scene), "cpu")
    tt.opt_pose_state = convert.adam_state_from_jax(_np(st.opt_pose), "cpu")
    tt.global_step = st.step
    # the chord bound depends on the seeded poses, which the two packages draw differently
    tt._k_phase = tt._mask_k = jt._mask_k
    assert np.array_equal(tt.mask_arr.numpy(), np.asarray(jt.mask_arr))


def _draws_from_jax(jt, rng, flags):
    """The port's draws rebuilt from the JAX step's keys: 0 the object batch
    (view, class, pick), 1 the object render jitter, 2 the projection view;
    the scene half as in the scene-only step test."""
    draws = _scene_draws_from_jax(jt, rng, flags)
    keys = jax.random.split(rng, 10)
    n_rand, n_active = jt.cfg.object_train.N_rand, flags["n_active"]
    k_view, k_class, k_pix = jax.random.split(keys[0], 3)
    T = lambda a, dt=torch.float32: torch.tensor(np.asarray(a), dtype=dt)  # noqa: E731
    draws["object"] = {
        "view": T(jax.random.randint(k_view, (n_rand,), 0, n_active), torch.int64),
        "cls": T(jax.random.choice(k_class, 3, (n_rand,), p=jnp.asarray(jbatch.SEMANTIC_FRACS)), torch.int64),
        "pick": T(jax.random.uniform(k_pix, (n_rand,)))}
    draws["object_jitter"] = T(jax.random.uniform(keys[1], (n_rand, 1)))
    draws["proj_view"] = int(jax.random.randint(keys[2], (), 0, n_active))
    return draws


def _assert_moments(jstate_leaves, tstate_leaves, name):
    scale = max(np.abs(a).max() for a in jstate_leaves)
    for a, b in zip(jstate_leaves, tstate_leaves):
        np.testing.assert_allclose(b, a, rtol=2e-3, atol=1e-5 * scale, err_msg=name)


@pytest.mark.parametrize("incremental,proj_use_deform", [(True, False), (False, True)],
                         ids=["two_views_zero_crossing", "all_views_rendered_depth"])
def test_early_step_matches_joint_trainer(incremental, proj_use_deform):
    jt, tt = _trainers(incremental)
    jt.state.step = 3
    _leave_the_init_state(jt)
    _carry_state(jt, tt)
    for s in range(2):
        _carry_state(jt, tt)
        flags = jt.phase_flags(jt.state.step)
        assert flags == tt.phase_flags(tt.global_step)
        assert flags["object_on"] and flags["pose_on"] and not flags["fine_on"]
        assert flags["proj_use_deform"] is proj_use_deform
        assert flags["n_active"] == (2 if incremental else 3)
        rng = jax.random.PRNGKey(7 + s)
        st = jt.state
        state = (st.obj_params, st.scene_params, st.pose_params, st.opt_obj, st.opt_scene,
                 st.opt_pose, st.poses_pnp)
        old_obj = _np(st.obj_params)
        r = int(jax.random.randint(jax.random.split(rng, 10)[2], (), 0, flags["n_active"]))
        pack = jt.obj_matches[r]
        proj_ref, _ = jproj.projection_error_loss(
            st.obj_params, jt.cfg.object_model,
            jpose_refine.current_pose_pnp(st.pose_params, st.poses_pnp, fix_first=True), jt.Ks,
            pack[:, 0:2], pack[:, 2:4], pack[:, 4], jt.pair_j[r], r, jnp.float32(st.step),
            jt.data.inverse_y, proj_use_deform, near=jt.data.near, far=jt.data.far,
            mask_grid=jt.mask_arr, mask_k=jt._mask_k)
        new, jm = jt._train_step(state, rng, jnp.asarray(st.step, jnp.int32), jt.mask_arr,
                                 mask_k=jt._mask_k, **flags)
        (st.obj_params, st.scene_params, st.pose_params, st.opt_obj, st.opt_scene,
         st.opt_pose, st.poses_pnp) = new
        st.step += 1
        tm = tt.step(_draws_from_jax(jt, rng, flags))
        assert set(jm) == set(tm)
        for k in jm:
            ref = float(proj_ref) if k == "proj_err" else float(jm[k])
            np.testing.assert_allclose(tm[k].item(), ref, rtol=1e-4, atol=1e-6, err_msg=k)

        # Adam moments (the gradients), per module of the object optimizer
        jobj = convert.adam_state_to_numpy(convert.object_adam_state_from_jax(_np(st.opt_obj), "cpu"))
        tobj = convert.adam_state_to_numpy(tt.opt_obj_state)
        assert jobj["count"] == tobj["count"] == s + 1
        for moment in ("mu", "nu"):
            assert set(jobj[moment]) == set(tobj[moment]) == set(LR) - {"s_val"}
            for key in jobj[moment]:
                _assert_moments(jax.tree.leaves(jobj[moment][key]), jax.tree.leaves(tobj[moment][key]),
                                f"{moment}/{key}")
        tscene = convert.adam_state_to_numpy(tt.opt_scene_state)
        for moment in ("mu", "nu"):
            _assert_moments(jax.tree.leaves(_np(getattr(st.opt_scene[1], moment))),
                            jax.tree.leaves(tscene[moment]), f"scene {moment}")
        for a, b in zip(jax.tree.leaves(_np(st.pose_params)),
                        jax.tree.leaves(convert.tree_to_numpy(tt.pose_params))):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)

        # params: equal where the gradient is well above float32 noise, and but for 1% elsewhere
        jobj_p, tobj_p = _np(st.obj_params), convert.tree_to_numpy(tt.obj_params)
        for key, lr in LR.items():
            diff = np.concatenate([np.abs(b - a).ravel() for a, b in zip(
                jax.tree.leaves(jobj_p[key]), jax.tree.leaves(tobj_p[key]))])
            if key == "s_val":
                assert diff.max() == 0.0
                continue
            mu = np.concatenate([np.abs(a).ravel() for a in jax.tree.leaves(jobj["mu"][key])])
            clear = mu >= 1e-2 * mu.max()
            assert clear.any() and diff[clear].max() <= 1e-3 * lr, (key, diff[clear].max() / lr)
            assert np.mean(diff > 1e-2 * lr) <= 0.01, (key, np.mean(diff > 1e-2 * lr))
        # reference behaviours kept: s_val is frozen; the deform net's
        # output_range is a trained leaf of `warpnet`
        assert np.array_equal(jobj_p["s_val"], old_obj["s_val"])
        assert np.array_equal(tobj_p["s_val"], old_obj["s_val"])
        moved = float(np.abs(jobj_p["warpnet"]["output_range"] - old_obj["warpnet"]["output_range"]))
        tmoved = float(np.abs(tobj_p["warpnet"]["output_range"] - old_obj["warpnet"]["output_range"]))
        np.testing.assert_allclose(tmoved, moved, rtol=1e-2, atol=1e-7)
        assert ("output_range" in tobj["mu"]["warpnet"]) and ("output_range" in jobj["mu"]["warpnet"])


@pytest.mark.parametrize("barrier", ["0", "1"])
def test_build_trainer_early_phase_on_cpu(barrier, monkeypatch):
    """The bench-shaped joint trainer at its small size: finite metrics in the
    early phase, the plastic-phase mask cache (all-True mask, chord-bound K),
    and no kernel launches on the CPU. With POSEPROBE_SCATTER_BARRIER=1 the
    same draws give the same loss."""
    monkeypatch.setenv("POSEPROBE_SCATTER_BARRIER", "0")
    tr = build_trainer(small=True, device="cpu", matmul_dtype="float32")
    om = tr.cfg.object_model
    assert tr.mask_arr.all() and tr.mask_arr.shape == om.world_size
    assert tr._mask_k == tr._k_phase and 1 < tr._k_phase <= om.n_samples
    tr.global_step = 1
    flags = tr.phase_flags(1)
    assert flags["object_on"] and not flags["proj_use_deform"] and flags["n_active"] == 2
    draws = tr.sample_draws(flags)
    before = (tgrid.fwd_launches, tgrid.bwd_launches, tlayout.transpose2d_launches,
              tlayout.transpose_slice_launches, tlayout.materialize_launches)
    with torch.no_grad():
        ref, _ = tr.joint_loss(tr.obj_params, tr.scene_params, tr.pose_params, 1, flags, draws)
    monkeypatch.setenv("POSEPROBE_SCATTER_BARRIER", barrier)
    m = tr.step(draws)
    assert set(m) == {"psnr_obj", "s_val", "proj_err", "psnr_scene", "loss_render", "loss_corres",
                      "loss_total"}
    assert all(np.isfinite(v.item()) for v in m.values()), m
    assert m["loss_total"].item() == ref.item()
    assert tr.global_step == 2 and tr.opt_obj_state["count"] == 1
    assert before == (tgrid.fwd_launches, tgrid.bwd_launches, tlayout.transpose2d_launches,
                      tlayout.transpose_slice_launches, tlayout.materialize_launches)


def test_phase_flags_and_maskcache_refresh_past_the_object_phase():
    tr = build_trainer(small=True, device="cpu", matmul_dtype="float32")
    n = tr.cfg.object_train.N_iters
    assert tr.phase_flags(n)["object_on"] and not tr.phase_flags(n + 1)["object_on"]
    tr.n_active = 3
    assert tr.phase_flags(n)["proj_use_deform"] and not tr.phase_flags(n + 1)["proj_use_deform"]
    tr.global_step = n + 1
    tr.refresh_maskcache()
    assert tr._mask_k is None and tr.mask_arr.dtype == torch.bool
    assert tr.mask_arr.shape == tr.cfg.object_model.world_size
    m = tr.step()      # a coarse-phase step of the joint trainer: the object branch is off
    assert "psnr_obj" not in m and np.isfinite(m["loss_total"].item())
    assert tr.opt_obj_state["count"] == 0


def test_pg_scale_resizes_grids_and_restarts_the_optimizer():
    import dataclasses
    from poseprobe_tpu_torch.train.trainer import _bench_workload
    cfg, data = _bench_workload(True, "float32")
    cfg = dataclasses.replace(cfg, object_train=dataclasses.replace(cfg.object_train, pg_scale=(2,)))
    tr = TJointTrainer(cfg, data, device="cpu")
    small = tr.cfg.object_model.world_size
    assert tr.cfg.object_model.num_voxels == 24 ** 3 // 2
    assert tuple(tr.obj_params["k0_grid"].shape) == (12,) + small
    tr.global_step = 1
    tr.fit(2)                       # steps 1 and 2: the scale event fires before step 2
    big = tr.cfg.object_model.world_size
    assert tr.cfg.object_model.num_voxels == 24 ** 3 and big > small
    assert tuple(tr.obj_params["sdf_grid"].shape) == (1,) + big
    assert tr.mask_arr.shape == big
    assert tr.opt_obj_state["count"] == 1 and tr.opt_obj_state["mu"]["sdf_grid"].shape == (1,) + big


@pytest.mark.parametrize("field,value", [("grid_type", "tensorf")])
def test_unported_options_raise(field, value):
    """The option that raised before it was ported (the name is kept from
    then) now builds: the trainer's
    k0 is the TensoRF planes and vectors, and the object optimizer keeps
    moments for each of them."""
    import dataclasses
    from poseprobe_tpu_torch.train.trainer import _bench_workload
    cfg, data = _bench_workload(True, "float32")
    cfg = dataclasses.replace(cfg, object_model=dataclasses.replace(cfg.object_model, **{field: value}))
    tr = TJointTrainer(cfg, data, device="cpu")
    k0 = tr.obj_params["k0_grid"]
    assert set(k0) == {"xy_plane", "xz_plane", "yz_plane", "x_vec", "y_vec", "z_vec", "f_vec"}
    assert {k: tuple(v.shape) for k, v in tr.opt_obj_state["mu"]["k0_grid"].items()} == \
        {k: tuple(v.shape) for k, v in k0.items()}


def test_surface_feature_term_builds_and_takes_its_own_cell():
    """`weight_surface_projection > 0` (ported): the trainer builds the feature
    maps, the early step adds the term, and a step with the term is a cell of
    its own for the captured-graph cache."""
    import dataclasses
    from poseprobe_tpu_torch.train.trainer import _bench_workload
    cfg, data = _bench_workload(True, "float32")
    cfg = dataclasses.replace(cfg, object_train=dataclasses.replace(cfg.object_train, lr_pose=1e-3))
    off = TJointTrainer(cfg, data, device="cpu")
    cfg = dataclasses.replace(cfg, object_train=dataclasses.replace(cfg.object_train, weight_surface_projection=0.1))
    on = TJointTrainer(cfg, data, device="cpu")
    assert off.feature_maps is None and tuple(on.feature_maps.shape) == (3, 64, 64, 5)
    flags = on.phase_flags(1)
    assert on._feature_term_on(flags) and not off._feature_term_on(flags)
    assert on._cell(flags)[-1] and not off._cell(flags)[-1]
    on.global_step = 1
    m = on.step()
    assert np.isfinite(m["feat_loss"].item()) and "feat_loss" not in off.step()
