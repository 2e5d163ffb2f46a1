"""The port's surface-feature slice held against the JAX package: the feature
maps (`eval/vgg_features.py`) on both paths, the image metrics, the bilinear
image lookup, `surface_feature_loss`, and one early joint step of the
`dtu_generic` preset with the term on.

Tolerances: the gradient-channel feature maps atol 1e-6; the VGG path (random
weights the test writes under the LPIPS key names) rtol 1e-4 with an atol of
1e-5 of the largest feature; the bilinear lookup as `check` holds values and
VJPs (rtol 1e-5 / 1e-4), points exactly on the border included.
`surface_feature_loss`: value rtol 1e-5, gradients for the SDF grid, the
deformation params and the poses rtol 2e-3 with an atol of 1e-5 of the
largest element, held against JAX run op by op (the reference's surface
query puts each ray's first sample on the box face, where XLA's fused
arithmetic moves samples across the in-box test), with the rays whose cycle
distance lies within 1e-5 of the 2-voxel gate, or whose surface point lies
within 1e-5 of a box face, left out. The joint step: the tolerances of
`test_torch_port_joint_step.py`, with its helpers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseprobe_tpu.config.presets import dtu_generic as jpreset
from poseprobe_tpu.core import geometry as jgeo
from poseprobe_tpu.data import loaders as jloaders
from poseprobe_tpu.eval import metrics as jmetrics, vgg_features as jvgg
from poseprobe_tpu.losses import projection as jproj
from poseprobe_tpu.train.trainer import JointTrainer as JJointTrainer
from poseprobe_tpu_torch import convert
from poseprobe_tpu_torch.config.presets import dtu_generic as tpreset
from poseprobe_tpu_torch.core import geometry as tgeo, pose as tpose, rays as trays
from poseprobe_tpu_torch.core.tree import tree_unflatten
from poseprobe_tpu_torch.data import loaders as tloaders, synthetic as tsyn
from poseprobe_tpu_torch.eval import metrics as tmetrics, vgg_features as tvgg
from poseprobe_tpu_torch.losses import projection as tproj
from poseprobe_tpu_torch.models import object_sdf as tobj
from poseprobe_tpu_torch.train.trainer import JointTrainer as TJointTrainer
from test_torch_port_core import check
from test_torch_port_data import write_fixture
from test_torch_port_joint_step import (LR, _assert_moments, _carry_state, _draws_from_jax,
                                        _leave_the_init_state, _np)
from test_torch_port_object import T, _assert_tree_grads, _object_state

torch.set_num_threads(1)

VGG_SHAPES = {0: (64, 3), 2: (64, 64), 5: (128, 64), 7: (128, 128), 10: (256, 128), 12: (256, 256),
              14: (256, 256), 17: (512, 256), 19: (512, 512), 21: (512, 512), 24: (512, 512),
              26: (512, 512), 28: (512, 512)}


@pytest.fixture
def vgg_weights(tmp_path, monkeypatch):
    """Random VGG16 + LPIPS-lin weights under the LPIPS key names, named by
    $POSEPROBE_LPIPS_WEIGHTS."""
    rng = np.random.default_rng(0)
    blobs = {}
    for li, (co, ci) in VGG_SHAPES.items():
        blobs[f"features.{li}.weight"] = rng.normal(0, np.sqrt(2.0 / (9 * ci)), (co, ci, 3, 3)).astype(np.float32)
        blobs[f"features.{li}.bias"] = rng.normal(0, 0.05, co).astype(np.float32)
    for i, c in enumerate((64, 128, 256, 512, 512)):
        blobs[f"lin{i}.model.1.weight"] = rng.random((1, c, 1, 1)).astype(np.float32)
    path = tmp_path / "lpips.npz"
    np.savez(path, **blobs)
    monkeypatch.setenv("POSEPROBE_LPIPS_WEIGHTS", str(path))
    return path


def _images(n=2, h=17, w=22, seed=0):
    return np.random.default_rng(seed).random((n, h, w, 3)).astype(np.float32)


# ---------------------------------------------------------------- feature maps and metrics


def test_feature_maps_without_weights(monkeypatch):
    monkeypatch.delenv("POSEPROBE_LPIPS_WEIGHTS", raising=False)
    imgs = _images()
    assert not tvgg.features_available()
    ref = jvgg.get_multi_features(imgs)
    out = tvgg.get_multi_features(imgs, device="cpu")
    assert out.shape == ref.shape == (2, 17, 22, 5) and out.device.type == "cpu"
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
    assert not out[:, :, 0, 3].any() and not out[:, 0, :, 4].any()      # zero border columns / rows


@pytest.mark.parametrize("hw", [(17, 22), (16, 24)])
def test_feature_maps_with_vgg_weights(vgg_weights, hw):
    imgs = _images(h=hw[0], w=hw[1], seed=1)
    assert tvgg.features_available() and jvgg.features_available()
    ref = jvgg.get_multi_features(imgs)
    out = tvgg.get_multi_features(imgs, device="cpu").numpy()
    assert out.shape == ref.shape == (2,) + hw + (64 + 128,)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max())


def test_image_metrics(vgg_weights):
    a, b = _images(1, 23, 29, seed=2)[0], _images(1, 23, 29, seed=3)[0]
    b = 0.7 * a + 0.3 * b
    np.testing.assert_allclose(tmetrics.psnr(T(a), T(b)).item(), float(jmetrics.psnr(a, b)), rtol=1e-5)
    np.testing.assert_allclose(tmetrics.ssim(T(a), T(b)).item(), float(jmetrics.ssim(a, b)), rtol=1e-5)
    assert tmetrics.lpips_available()
    blobs = dict(np.load(vgg_weights))
    ref = float(jax.jit(jmetrics._lpips_vgg)(a, b, blobs))     # `lpips_fn` op by op, compiled once
    assert tmetrics.lpips_fn(a, b) == pytest.approx(ref, rel=1e-4)
    depth, gt = a[..., 0] + 1, np.where(b[..., 0] > 0.5, b[..., 0] + 1, 0)
    assert tmetrics.depth_abs_rmse(T(depth), gt, scale=1.1) == jmetrics.depth_abs_rmse(depth, gt, scale=1.1)
    assert np.isnan(tmetrics.depth_abs_rmse(depth, np.zeros_like(gt))[0])


def test_lpips_is_gated(monkeypatch):
    monkeypatch.delenv("POSEPROBE_LPIPS_WEIGHTS", raising=False)
    with pytest.raises(tmetrics.LPIPSUnavailable):
        tmetrics.lpips_fn(np.zeros((8, 8, 3)), np.zeros((8, 8, 3)))


# ---------------------------------------------------------------- bilinear image lookup


def test_bilinear_image_sample_with_pixel_gradients():
    rng = np.random.default_rng(4)
    img = rng.random((7, 9, 5)).astype(np.float32)
    px = rng.uniform(-1.0, 10.0, (40, 2)).astype(np.float32)
    # exactly on the border and on the last cell's far edge, where the clips tie
    px[:8] = [[0, 0], [8, 6], [8, 3.5], [2.5, 6], [0, 3.3], [8, 0], [4, 5], [7, 1]]
    check(lambda p: jgeo.bilinear_image_sample(jnp.asarray(img), p),
          lambda p: tgeo.bilinear_image_sample(T(img), p), [px], grad_argnums=(0,))
    # the trap the clip avoids: torch.clamp passes the whole gradient at a tie
    p = T(px[1:2], True)
    tgeo.bilinear_image_sample(T(img), p).sum().backward()
    q = T(px[1:2], True)
    torch.clamp(q, 0.0, 8.0).sum().backward()
    assert q.grad[0, 0].item() == 1.0
    jg = jax.grad(lambda v: jnp.clip(v, 0.0, 8.0).sum())(jnp.asarray(px[1:2]))
    assert float(jg[0, 0]) == 0.5
    assert tgeo.clip(T(px[1:2, 0], True), 0.0, 8.0).grad_fn is not None


# ---------------------------------------------------------------- surface-feature loss


def _feature_case(n_rays=64, seed=8):
    """The object state of the object tests, three cameras of the synthetic
    scene brought to its box, gradient-channel feature maps of the scene's
    images, and rays of view 0 through random pixels."""
    jp, tp, jc, tc = _object_state(seed=seed)
    data = tsyn.make_synthetic_scene(n_train=3, n_test=1, H=32, W=32, seed=0, n_matches=8, texture="noise")
    poses = np.array(data.poses_gt_w2c[:3])
    poses[:, :, 3] *= 0.5 / float(data.xyz_max[0])
    Ks = np.asarray(data.Ks[:3])
    maps = tvgg.get_multi_features(data.images[:3], device="cpu").numpy()
    px = np.random.default_rng(seed).uniform(6, 26, (n_rays, 2)).astype(np.float32)
    o, d = trays.get_ray_dir(T(px)[None], T(Ks[:1]), tpose.invert(T(poses[:1])), inverse_y=True, mode="no_center")
    return jp, tp, jc, tc, poses, Ks, maps, o[0].numpy(), d[0].numpy()


def _away_from_the_gates(tp, tc, poses, Ks, o, d, j):
    """Rays whose cycle distance is not within 1e-5 of the 2-voxel gate and
    whose surface point is not within 1e-5 of a box face (the port's surface
    query, which the object tests hold against op-by-op JAX), and the rays
    that pass the gate."""
    kw = dict(use_deform=True, near=0.2, far=4.0)
    with torch.no_grad():
        pts, _, _ = tobj.query_surface_points_render(tp, tc, T(o), T(d), 30, **kw)
        px_j, _ = tproj._project_with_near_clamp(pts[None], T(poses[j])[None], T(Ks[j])[None], True)
        ro, rd = trays.get_ray_dir(px_j, T(Ks[j])[None], tpose.invert(T(poses[j])[None]), inverse_y=True,
                                   mode="no_center")
        ref, _, _ = tobj.query_surface_points_render(tp, tc, ro.reshape(-1, 3), rd.reshape(-1, 3), 30, **kw)
    dist = np.linalg.norm((pts - ref).numpy(), axis=-1)
    face = np.minimum(np.abs(pts.numpy() - tc.xyz_min_np), np.abs(pts.numpy() - tc.xyz_max_np)).min(-1)
    return (np.abs(dist - 2 * tc.voxel_size) > 1e-5) & (face > 1e-5), dist < 2 * tc.voxel_size


def test_surface_feature_loss_matches_jax():
    jp, tp, jc, tc, poses, Ks, maps, o, d = _feature_case()
    keep, cycle_ok = _away_from_the_gates(tp, tc, poses, Ks, o, d, 1)
    o, d = o[keep], d[keep]
    assert cycle_ok[keep].sum() >= 8 and (~cycle_ok[keep]).sum() >= 1      # both sides of the gate
    kw = dict(global_step=30.0, inverse_y=True, use_deform=True, near=0.2, far=4.0)

    def jf(pose, p):
        return jproj.surface_feature_loss(p, jc, pose, jnp.asarray(Ks), jnp.asarray(o), jnp.asarray(d), 0, 1,
                                          jnp.asarray(maps), **kw)

    jl, (jg_pose, jg_p) = jax.value_and_grad(jf, argnums=(0, 1))(jnp.asarray(poses), jp)   # op by op
    leaves = [x.requires_grad_(True) for x in jax.tree.leaves(tp)]
    tpose = T(poses, True)
    tl, n_valid = tproj.surface_feature_loss(tp, tc, tpose, T(Ks), T(o), T(d), torch.tensor(0), torch.tensor(1),
                                             T(maps), **kw)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert 0 < n_valid.item() < len(o) and 0 < float(jl) < 1
    tg = torch.autograd.grad(tl, leaves + [tpose], allow_unused=True)
    tg = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves + [tpose], tg)]
    tgrads = tree_unflatten(tp, tg[:-1])
    for key in ("sdf_grid", "warpnet"):
        assert np.abs(np.concatenate([np.ravel(a) for a in jax.tree.leaves(_np(jg_p[key]))])).max() > 0, key
        _assert_tree_grads(tgrads[key], jg_p[key], rtol=2e-3)
    _assert_tree_grads([tg[-1]], [jg_pose], rtol=2e-3)
    # the term is graph-safe: view ids as 0-dim tensors or ints give the same value
    same, same_valid = tproj.surface_feature_loss(tp, tc, T(poses), T(Ks), T(o), T(d), 0, 1, T(maps), **kw)
    assert same.item() == tl.item() and same_valid.item() == n_valid.item()


# ---------------------------------------------------------------- the preset's early step


def _dtu_generic_trainers(root):
    fields = write_fixture("dtu", root)
    SM = dict(layers_feat=(32,) * 4, layers_rgb=(16, 3), skip=(2,), L_3D=4, L_view=2, sample_intvs=16,
              sample_intvs_fine=16, rand_rays=64, matmul_dtype="float32")
    out = []
    for preset, loaders, trainer, extra in ((jpreset, jloaders, JJointTrainer, {}),
                                            (tpreset, tloaders, TJointTrainer, {"device": "cpu"})):
        cfg = preset.get_config(datadir=fields["datadir"], selected_id=fields["selected_id"])
        # the widths of the joint-step test: a 12^3 grid after the preset's pg_scale shrink, 48 rays
        cfg = dataclasses.replace(
            cfg,
            object_model=dataclasses.replace(cfg.object_model, num_voxels=8 * 12 ** 3, num_voxels_base=8 * 12 ** 3),
            object_train=dataclasses.replace(cfg.object_train, N_rand=48),
            scene_model=dataclasses.replace(cfg.scene_model, **SM))
        data = loaders.load_data(cfg.data, matcher_backend="classical")
        out.append(trainer(cfg, data, **extra))
    return out


def test_dtu_generic_early_step_matches_joint_trainer(tmp_path):
    jt, tt = _dtu_generic_trainers(str(tmp_path))
    assert tt.cfg.object_model.world_size == jt.cfg.object_model.world_size
    assert tt.feature_maps is not None and jt.feature_maps is not None
    np.testing.assert_allclose(tt.feature_maps.numpy(), np.asarray(jt.feature_maps), rtol=0, atol=1e-6)
    jt.state.step = 3
    _leave_the_init_state(jt)
    _carry_state(jt, tt)
    flags = jt.phase_flags(jt.state.step)
    assert flags == tt.phase_flags(tt.global_step)
    assert flags["object_on"] and flags["pose_on"] and tt._feature_term_on(flags)
    rng = jax.random.PRNGKey(11)
    st = jt.state
    state = (st.obj_params, st.scene_params, st.pose_params, st.opt_obj, st.opt_scene, st.opt_pose, st.poses_pnp)
    new, jm = jt._train_step(state, rng, jnp.asarray(st.step, jnp.int32), jt.mask_arr, mask_k=jt._mask_k, **flags)
    (st.obj_params, st.scene_params, st.pose_params, st.opt_obj, st.opt_scene, st.opt_pose, st.poses_pnp) = new
    draws = _draws_from_jax(jt, rng, flags)
    draws["feat_view"] = int(jax.random.randint(jax.random.split(rng, 10)[8], (), 0, flags["n_active"]))
    tm = tt.step(draws)
    assert set(jm) | {"feat_rays", "maskcache_fill"} == set(tm) and "feat_loss" in jm
    assert tm["feat_rays"].item() > 0
    for k in jm:
        if k != "proj_err":     # held op by op in the joint-step test; its weight here is 1e-3
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    jobj_s = convert.adam_state_to_numpy(convert.object_adam_state_from_jax(_np(st.opt_obj), "cpu"))
    tobj_s = convert.adam_state_to_numpy(tt.opt_obj_state)
    for moment in ("mu", "nu"):
        for key in jobj_s[moment]:
            _assert_moments(jax.tree.leaves(jobj_s[moment][key]), jax.tree.leaves(tobj_s[moment][key]),
                            f"{moment}/{key}")
        _assert_moments(jax.tree.leaves(_np(getattr(st.opt_scene[1], moment))),
                        jax.tree.leaves(convert.adam_state_to_numpy(tt.opt_scene_state)[moment]), f"scene {moment}")
    for a, b in zip(jax.tree.leaves(_np(st.pose_params)), jax.tree.leaves(convert.tree_to_numpy(tt.pose_params))):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    jobj_p, tobj_p = _np(st.obj_params), convert.tree_to_numpy(tt.obj_params)
    for key, lr in LR.items():
        if key == "s_val":
            continue
        diff = np.concatenate([np.abs(b - a).ravel() for a, b in zip(
            jax.tree.leaves(jobj_p[key]), jax.tree.leaves(tobj_p[key]))])
        mu = np.concatenate([np.abs(a).ravel() for a in jax.tree.leaves(jobj_s["mu"][key])])
        clear = mu >= 1e-2 * mu.max()
        assert clear.any() and diff[clear].max() <= 1e-3 * lr, (key, diff[clear].max() / lr)
        assert np.mean(diff > 1e-2 * lr) <= 0.01, (key, np.mean(diff > 1e-2 * lr))
