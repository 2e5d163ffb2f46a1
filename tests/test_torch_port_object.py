"""Parity of the port's object branch with the JAX package, at float32 on the CPU:
mask cache, ray sampling, NeuS alpha, the object PE, the deformation field, the
SDF render and surface queries, the object and reprojection losses, the
semantic batch sampler and the object optimizer.

The same numpy inputs (from a seed) go through the JAX function and its port.
Values: rtol/atol 1e-5 unless a case states otherwise; gradients rtol 1e-4
with an atol of 1e-5 of the largest element of the gradient (sums over
thousands of samples in another order). Random draws the JAX functions make
from keys are rebuilt with `jax.random` and handed to the port as tensors.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseprobe_tpu.config import config as jcfg
from poseprobe_tpu.core import geometry as jgeo, rays as jrays
from poseprobe_tpu.data import base as jbase, synthetic as jsyn
from poseprobe_tpu.losses import object as jobj_l, projection as jproj
from poseprobe_tpu.models import deform as jdeform, object_sdf as jobj
from poseprobe_tpu.ops import compositing as jcomp, maskcache as jmc, pe as jpe, ray_sampling as jrs
from poseprobe_tpu.train import batching as jbatch, optim as joptim
from poseprobe_tpu_torch import convert
from poseprobe_tpu_torch.config import config as tcfg
from poseprobe_tpu_torch.core import geometry as tgeo, rays as trays
from poseprobe_tpu_torch.data import base as tbase, synthetic as tsyn
from poseprobe_tpu_torch.losses import object as tobj_l, projection as tproj
from poseprobe_tpu_torch.models import deform as tdeform, object_sdf as tobj
from poseprobe_tpu_torch.ops import compositing as tcomp, maskcache as tmc, pe as tpe, ray_sampling as trs
from poseprobe_tpu_torch.train import batching as tbatch, optim as toptim
from test_torch_port_core import _K, _rand, _rot_pose, check

torch.set_num_threads(1)

OC = dict(xyz_min=(-0.5, -0.5, -0.5), xyz_max=(0.5, 0.5, 0.5), num_voxels=10 ** 3,
          num_voxels_base=10 ** 3, N_iters=100, world_bound_scale=1.25, barf_c2f=(0.05, 0.4))


def T(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_grads(tgrads, jgrads, rtol=1e-4, floor=1e-30):
    for a, b in zip(jax.tree.leaves(_np(jgrads)), jax.tree.leaves(convert.tree_to_numpy(tgrads))):
        np.testing.assert_allclose(b, a, rtol=rtol, atol=max(1e-5 * np.abs(a).max(), floor))


def _object_state(seed=0, **over):
    """JAX object params off the init state (trained-looking grids, non-zero
    deformation), their port copy, and both configs."""
    jc, tc = jobj.ObjectConfig(**{**OC, **over}), tobj.ObjectConfig(**{**OC, **over})
    p = jobj.init_object_params(jax.random.PRNGKey(seed), jc)
    rng = np.random.default_rng(seed)
    layers = [dict(la) for la in p["warpnet"]["layers"]]
    layers[-1] = {k: v + jnp.asarray(rng.normal(0, 2e-2, v.shape), jnp.float32) for k, v in layers[-1].items()}
    p = dict(p, warpnet=dict(p["warpnet"], layers=layers),
             k0_grid=jnp.asarray(rng.normal(0, 0.3, p["k0_grid"].shape), jnp.float32),
             sdf_grid=p["sdf_grid"] + jnp.asarray(rng.normal(0, 0.01, p["sdf_grid"].shape), jnp.float32))
    return p, convert.object_params_from_jax(_np(p), "cpu"), jc, tc


def _rays(n, seed=0):
    """Rays from cameras ~2 units from the box, most of them hitting it."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = (o / np.linalg.norm(o, axis=-1, keepdims=True) * 2.0).astype(np.float32)
    target = rng.uniform(-0.6, 0.6, (n, 3))
    d = (target - o).astype(np.float32)
    d *= rng.uniform(0.5, 1.5, (n, 1)).astype(np.float32)
    return o, d, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


# ---------------------------------------------------------------- config and init


def test_object_config_derived_properties():
    for over in ({}, dict(xyz_min=(-0.6, -0.6, -0.75), xyz_max=(0.6, 0.6, 0.45), num_voxels=96 ** 3,
                          maskcache_keep=0.3, stepsize=1.0)):
        j, t = jobj.ObjectConfig(**{**OC, **over}), tobj.ObjectConfig(**{**OC, **over})
        assert {f.name for f in dataclasses.fields(j)} == {f.name for f in dataclasses.fields(t)}
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        for prop in ("voxel_size", "voxel_size_base", "world_size", "n_samples", "maskcache_K",
                     "range_shape_max", "diagonal_length"):
            assert getattr(j, prop) == getattr(t, prop), prop
        assert np.array_equal(j.rect_size, t.rect_size) and j.rgbnet_in_dim() == t.rgbnet_in_dim()
    # the reference's formula (an apparent typo) is kept: sqrt(sum(max - min**2))
    c = tobj.ObjectConfig()
    assert c.diagonal_length == float(np.sqrt(np.sum(c.xyz_max_np - c.xyz_min_np ** 2)))
    assert jcfg.ObjectTrainConfig() == jcfg.ObjectTrainConfig(**dataclasses.asdict(tcfg.ObjectTrainConfig()))


def test_cube_init_maskout_and_param_tree():
    jc, tc = jobj.ObjectConfig(**OC), tobj.ObjectConfig(**OC)
    assert np.array_equal(np.asarray(jobj.cube_sdf_init(jc)), tobj.cube_sdf_init(tc))
    jp = jobj.init_object_params(jax.random.PRNGKey(0), jc)
    tp = tobj.init_object_params(torch.Generator().manual_seed(0), tc, "cpu")
    jl, tl = jax.tree.leaves(_np(jp)), jax.tree.leaves(convert.tree_to_numpy(tp))
    assert jax.tree.structure(_np(jp)) == jax.tree.structure(convert.tree_to_numpy(tp))
    assert [a.shape for a in jl] == [b.shape for b in tl]
    for key in ("sdf_grid", "k0_grid", "sdf_alpha", "sdf_beta", "s_val"):
        assert np.array_equal(np.asarray(jp[key]), tp[key].numpy())
    assert float(tp["warpnet"]["output_range"]) == float(jp["warpnet"]["output_range"])
    assert not tp["warpnet"]["layers"][-1]["w"].any() and not tp["rgbnet"][-1]["b"].any()
    cams = np.array([[0.45, 0.0, 0.7], [-0.8, 0.3, 0.2]], np.float32)
    jm = jobj.maskout_near_cam_vox(jp, jc, cams, 0.5)["sdf_grid"]
    tm = tobj.maskout_near_cam_vox(tp, tc, cams, 0.5)["sdf_grid"]
    assert np.array_equal(np.asarray(jm), tm.numpy()) and (tm == 1.0).sum() > 0


@pytest.mark.parametrize("over", [dict(grid_type="tensorf"), dict(use_pallas_composite=True)])
def test_unported_object_options_raise(over):
    _, tp, _, _ = _object_state()
    o, d, v = _rays(4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tobj.render(tp, tobj.ObjectConfig(**{**OC, **over}), T(o), T(d), T(v), 10)


def test_semantic_samplers_identical():
    masks = jsyn.make_synthetic_scene(n_train=3, n_test=1, H=32, W=32, seed=0, n_matches=16)
    tdata = tsyn.make_synthetic_scene(n_train=3, n_test=1, H=32, W=32, seed=0, n_matches=16)
    assert np.array_equal(masks.samplers.pixels, tdata.samplers.pixels)
    assert np.array_equal(masks.samplers.counts, tdata.samplers.counts)
    j = jbase.build_semantic_samplers(masks.masks, blur_sigma=2.0)
    t = tbase.build_semantic_samplers(tdata.masks, blur_sigma=2.0)
    assert np.array_equal(j.pixels, t.pixels) and np.array_equal(j.counts, t.counts)


# ---------------------------------------------------------------- ops


def test_mask_lookup_and_mask_grids():
    rng = np.random.default_rng(0)
    mask = rng.random((6, 7, 5)) < 0.5
    lo, hi = np.array([-0.5, -0.4, -0.6], np.float32), np.array([0.5, 0.6, 0.3], np.float32)
    pts = rng.uniform(lo - 0.2, hi + 0.2, (40, 9, 3)).astype(np.float32)
    # points exactly between two voxels: rint rounds half to even
    pts[0, :, 0] = lo[0] + (np.arange(9) % 5 + 0.5) / 5.0 * (hi[0] - lo[0])
    ref = np.asarray(jmc.mask_lookup(jnp.asarray(mask), jnp.asarray(pts), jnp.asarray(lo), jnp.asarray(hi)))
    out = tmc.mask_lookup(T(mask), T(pts), T(lo), T(hi))
    assert np.array_equal(out.numpy(), ref)
    sdf = rng.normal(size=(1, 8, 7, 9)).astype(np.float32)
    for dilate in (1, 3, 5):
        assert np.array_equal(tmc.build_mask_grid(T(sdf), 0.1, dilate).numpy(),
                              np.asarray(jmc.build_mask_grid(jnp.asarray(sdf), 0.1, dilate)))
        assert np.array_equal(tmc.build_mask_grid_mapped(T(sdf), 0.2, 3.0, dilate).numpy(),
                              np.asarray(jmc.build_mask_grid_mapped(jnp.asarray(sdf), 0.2, 3.0, dilate)))
    # the never-strangle floor: an almost-empty rebuild returns prev (or all-True)
    prev = rng.random((8, 7, 9)) < 0.5
    assert np.array_equal(tmc.build_mask_grid_mapped(T(sdf + 10.0), 0.2, prev=T(prev)).numpy(), prev)
    assert tmc.build_mask_grid_mapped(T(sdf + 10.0), 0.2).all()


def test_max_inbbox_lanes_matches():
    poses, Ks = np.array(_rot_pose(3, seed=2)), _K(3)
    poses[:, :, 3] += np.array([0.0, 0.0, 2.0], np.float32)
    args = (poses, Ks, 32, 32, np.full(3, -0.5), np.full(3, 0.5), 0.07)
    assert tmc.max_inbbox_lanes(*args) == jmc.max_inbbox_lanes(*args) > 6


@pytest.mark.parametrize("K", [5, 12, 20])
def test_compact_ray_samples(K):
    rng = np.random.default_rng(1)
    pts, step = rng.normal(size=(30, 20, 3)).astype(np.float32), rng.normal(size=(30, 20)).astype(np.float32)
    keep = rng.random((30, 20)) < 0.4
    ref = jmc.compact_ray_samples(jnp.asarray(pts), jnp.asarray(step), jnp.asarray(keep), K)
    out = tmc.compact_ray_samples(T(pts), T(step), T(keep), K)
    for a, b in zip(ref, out):
        assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("jittered", [False, True])
def test_sample_ray(jittered):
    o, d, _ = _rays(50, seed=3)
    d[0] = [0.0, 0.0, 1.0]                      # zero components take the 1e-6 guard
    lo, hi = np.full(3, -0.5, np.float32), np.full(3, 0.5, np.float32)
    key = jax.random.PRNGKey(0) if jittered else None
    jitter = np.asarray(jax.random.uniform(key, (50, 1))) if jittered else None
    assert trs.n_samples_for_grid((10, 12, 9), 1.5) == jrs.n_samples_for_grid((10, 12, 9), 1.5)

    def jf(o, d):
        return jrs.sample_ray(o, d, jnp.asarray(lo), jnp.asarray(hi), 0.5, 8.5, 1.5, jnp.asarray(0.1), 17, rng=key)

    def tf(o, d):
        return trs.sample_ray(o, d, T(lo), T(hi), 0.5, 8.5, 1.5, 0.1, 17,
                              jitter=None if jitter is None else T(jitter))
    floats = lambda s: (s.pts, s.step, s.t_min, s.t_max)  # noqa: E731
    check(lambda o, d: floats(jf(o, d)), lambda o, d: floats(tf(o, d)), [o, d], grad_argnums=(0, 1))
    # The in-box mask against JAX run op by op: without jitter a ray's first
    # sample lies exactly on the box face, and under jit XLA's fused arithmetic
    # moves some of them across the test.
    ref = jf(jnp.asarray(o), jnp.asarray(d)).mask_inbbox
    out = tf(T(o), T(d)).mask_inbbox
    assert np.array_equal(out.numpy(), np.asarray(ref)) and 0 < int(out.sum()) < out.numel()


def test_neus_alpha_and_s_val_schedule():
    rng = np.random.default_rng(4)
    view = _rays(20, seed=4)[2][:, None, :]
    sdf = rng.normal(0, 0.2, (20, 15)).astype(np.float32)
    grad = rng.normal(size=(20, 15, 3)).astype(np.float32)
    for step in (0, 10, 5000):
        s = tcomp.s_val_schedule(step, 50.0, 0.2, 0)
        np.testing.assert_allclose(s, float(jcomp.s_val_schedule(jnp.float32(step), 50.0, 0.2, 0)), rtol=1e-6)
        # at step 5000 the sigmoid is so sharp (1/s = 105) that the gradient's
        # float32 error passes 1e-5: values only there
        check(lambda v, sd, g: jcomp.neus_alpha_from_sdf(v, 0.1, sd, g, s),
              lambda v, sd, g: tcomp.neus_alpha_from_sdf(v, 0.1, sd, g, s), [view, sdf, grad],
              grad_argnums=(1, 2) if step < 5000 else ())


@pytest.mark.parametrize("progress", [0.0, 0.2, 1.0])
def test_posenc_object(progress):
    x = _rand((7, 5, 3), seed=5)
    for c2f in (None, (0.05, 0.4)):
        check(lambda x: jpe.posenc_object(x, 5, progress, c2f),
              lambda x: tpe.posenc_object(x, 5, progress, c2f), [x], grad_argnums=(0,))


def test_object_ray_and_projection_geometry():
    pts2d = np.random.default_rng(6).uniform(0, 32, (2, 9, 2)).astype(np.float32)
    K, c2w = _K(2), _rot_pose(2, seed=6)
    for inverse_y in (True, False):
        for mode in ("center", "no_center"):
            check(lambda p, c: jrays.get_ray_dir(p, jnp.asarray(K), c, inverse_y, mode=mode),
                  lambda p, c: trays.get_ray_dir(p, T(K), c, inverse_y, mode=mode), [pts2d, c2w],
                  grad_argnums=(0, 1))
    cam = _rand((2, 9, 3), seed=7) + np.array([0, 0, 3.0], np.float32)
    check(jgeo.project_to_cam, tgeo.project_to_cam, [cam, K], grad_argnums=(0,))
    o, d, v = _rays(12, seed=8)
    check(jgeo.point_to_ray_distance, tgeo.point_to_ray_distance,
          [o, np.concatenate([v[:6], -v[6:]]), np.array([0.1, -0.2, 0.05], np.float32)], grad_argnums=(0, 1))


# ---------------------------------------------------------------- deformation field


def test_deform_with_jacobian_fwd():
    jp, tp, _, _ = _object_state(seed=1)
    pts = _rand((6, 7, 3), seed=9, scale=0.3)
    jout = jdeform.deform_with_jacobian_fwd(jp["warpnet"], jnp.asarray(pts))
    tout = tdeform.deform_with_jacobian_fwd(tp["warpnet"], T(pts))
    for a, b in zip(jout, tout):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)
    # against the autograd cross-check, in both packages
    jd, jc, jjac = jdeform.deform_with_jacobian(jp["warpnet"], jnp.asarray(pts))
    td, tc, tjac = tdeform.deform_with_jacobian(tp["warpnet"], T(pts))
    np.testing.assert_allclose(tjac.numpy(), np.asarray(jjac), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tout[2].numpy(), tjac.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), tout[0].numpy(), rtol=1e-6, atol=1e-7)
    ad, ac = tdeform.apply_deform(tp["warpnet"], T(pts))
    assert torch.equal(ad, td) and torch.equal(ac, tc)
    # VJP to the parameters (output_range included) and the points
    cots = [_rand(np.shape(a), seed=10 + i) for i, a in enumerate(jout)]
    jg = jax.grad(lambda w, p: sum((o * c).sum() for o, c in zip(jdeform.deform_with_jacobian_fwd(w, p), cots)),
                  argnums=(0, 1))(jp["warpnet"], jnp.asarray(pts))
    w = convert.tree_from_numpy(_np(jp["warpnet"]), "cpu")
    leaves = [x.requires_grad_(True) for x in jax.tree.leaves(w)]
    p = T(pts, True)
    total = sum((o * T(c)).sum() for o, c in zip(tdeform.deform_with_jacobian_fwd(w, p), cots))
    tg = torch.autograd.grad(total, leaves + [p])
    _assert_tree_grads(list(tg[:-1]), jg[0])
    _assert_tree_grads([tg[-1]], [jg[1]])
    assert float(np.abs(np.asarray(jg[0]["output_range"]))) > 0


# ---------------------------------------------------------------- render and surface queries


RENDER_KEYS = ("rgb_marched", "normal_marched", "cum_weights", "alphainv_cum", "weights", "raw_alpha",
               "depth", "disp", "mask", "gradient", "s_val", "n_step")


@pytest.mark.parametrize("use_deform", [True, False])
@pytest.mark.parametrize("masked", [None, "all_true_chord_k", "occupancy"])
def test_render_matches_jax(use_deform, masked):
    jp, tp, jc, tc = _object_state(seed=2, fast_color_thres=1e-4 if masked == "occupancy" else 0.0)
    o, d, v = _rays(40, seed=11)
    key = jax.random.PRNGKey(3)
    jitter = np.asarray(jax.random.uniform(key, (40, 1)))
    mask_grid, mask_k = None, None
    if masked == "all_true_chord_k":
        mask_grid, mask_k = np.ones(jc.world_size, bool), jc.n_samples - 3
    elif masked == "occupancy":
        mask_grid = np.asarray(jmc.build_mask_grid(jp["sdf_grid"], 0.15, 3))
    kw = dict(use_deform=use_deform, is_train=True, near=0.5, far=8.5, bg=1.0, mask_k=mask_k)

    def jloss(p):
        out = jobj.render(p, jc, jnp.asarray(o), jnp.asarray(d), jnp.asarray(v), jnp.float32(30.0), rng=key,
                          mask_grid=None if mask_grid is None else jnp.asarray(mask_grid), **kw)
        return _scalar(out, jnp), out

    (jl, jout), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    leaves = [x.requires_grad_(True) for x in jax.tree.leaves(tp)]
    tout = tobj.render(tp, tc, T(o), T(d), T(v), 30, jitter=T(jitter),
                       mask_grid=None if mask_grid is None else T(mask_grid), **kw)
    assert set(tout) == set(jout)
    for k in jout:
        np.testing.assert_allclose(tout[k].detach().numpy(), np.asarray(jout[k]), rtol=1e-5, atol=2e-5, err_msg=k)
    tl = _scalar(tout, torch)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    tg = torch.autograd.grad(tl, leaves, allow_unused=True)
    tg = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, tg)]
    _assert_tree_grads(tg, jg)


def _scalar(out, xp):
    """A scalar that reaches every differentiable output of `render`."""
    total = (out["rgb_marched"] ** 2).sum() + out["cum_weights"].sum() + (out["depth"] * 0.1).sum()
    total = total + (out["gradient"] ** 2).sum() * 1e-3 + out["alphainv_cum"].sum()
    total = total + (out["normal_marched"] * 0.3).sum()
    if "sdf_deform" in out:
        total = total + (out["sdf_deform"] ** 2).sum() + (out["grad_deform"] ** 2).sum() * 1e-2
        total = total + (out["sdf_correct"] ** 2).sum()
    return total


def test_compaction_with_full_budget_equals_masked_dense():
    _, tp, _, tc = _object_state(seed=3)
    o, d, v = _rays(30, seed=12)
    dense = tobj.render(tp, tc, T(o), T(d), T(v), 30, use_deform=True, near=0.5, far=8.5)
    comp = tobj.render(tp, tc, T(o), T(d), T(v), 30, use_deform=True, near=0.5, far=8.5,
                       mask_grid=torch.ones(tc.world_size, dtype=torch.bool), mask_k=tc.n_samples)
    for k in ("rgb_marched", "depth", "cum_weights", "alphainv_cum"):
        np.testing.assert_allclose(comp[k].detach().numpy(), dense[k].detach().numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("use_deform", [False, True])
def test_query_surface_points(use_deform):
    jp, tp, jc, tc = _object_state(seed=4)
    o, d, _ = _rays(40, seed=13)
    jpts, jvalid, jsdf = jobj.query_surface_points(jp, jc, jnp.asarray(o), jnp.asarray(d), use_deform=use_deform,
                                                   near=0.5, far=8.5)
    tpts, tvalid, tsdf = tobj.query_surface_points(tp, tc, T(o), T(d), use_deform=use_deform, near=0.5, far=8.5)
    assert np.array_equal(tvalid.numpy(), np.asarray(jvalid)) and 5 < int(tvalid.sum()) < 40
    np.testing.assert_allclose(tsdf.numpy(), np.asarray(jsdf), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tpts.numpy(), np.asarray(jpts), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("use_deform", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_query_surface_points_render(use_deform, masked):
    jp, tp, jc, tc = _object_state(seed=5)
    o, d, _ = _rays(40, seed=14)
    mask = np.ones(jc.world_size, bool) if masked else None
    kw = dict(use_deform=use_deform, near=0.5, far=8.5, mask_k=jc.n_samples - 2 if masked else None)

    def jf(p, o, d):
        pts, valid, depth = jobj.query_surface_points_render(
            p, jc, o, d, jnp.float32(30.0), mask_grid=None if mask is None else jnp.asarray(mask), **kw)
        return (pts ** 2).sum() + depth.sum(), (pts, valid, depth)

    (jl, (jpts, jvalid, jdepth)), jg = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        jp, jnp.asarray(o), jnp.asarray(d))
    leaves = [x.requires_grad_(True) for x in jax.tree.leaves(tp)]
    to, td = T(o, True), T(d, True)
    tpts, tvalid, tdepth = tobj.query_surface_points_render(tp, tc, to, td, 30,
                                                            mask_grid=None if mask is None else T(mask), **kw)
    assert np.array_equal(tvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(tdepth.detach().numpy(), np.asarray(jdepth), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tpts.detach().numpy(), np.asarray(jpts), rtol=1e-5, atol=1e-5)
    tg = torch.autograd.grad((tpts ** 2).sum() + tdepth.sum(), leaves + [to, td], allow_unused=True)
    tg = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves + [to, td], tg)]
    _assert_tree_grads(tg[:-2], jg[0])
    _assert_tree_grads(tg[-2:], list(jg[1:]))


# ---------------------------------------------------------------- losses


@pytest.mark.parametrize("use_deform", [True, False])
def test_object_losses(use_deform):
    rng = np.random.default_rng(15)
    N, S = 20, 9
    out = {"rgb_marched": rng.random((N, 3)), "alphainv_cum": rng.random(N), "gradient": rng.normal(size=(N, S, 3)),
           "mask": rng.random((N, S)) < 0.6, "cum_weights": rng.random((N, 1)),
           "grad_deform": rng.normal(size=(N, S, 3, 3)), "sdf_correct": rng.normal(size=(N, S, 1)),
           "sdf_deform": rng.normal(size=(N, S))}
    out = {k: v.astype(np.float32) if v.dtype != bool else v for k, v in out.items()}
    target, mask = rng.random((N, 3)).astype(np.float32), (rng.random((N, 1)) < 0.5).astype(np.float32)
    names = [k for k in out if k != "mask"]
    kw = dict(weight_main=1.0, weight_mask=0.1, weight_tv_k0=0.01, use_deform=use_deform)

    def jf(*vals):
        o = dict(zip(names, vals), mask=jnp.asarray(out["mask"]))
        sc, w, total, psnr = jobj_l.object_losses(o, jnp.asarray(target), jnp.asarray(mask), jnp.float32(37.0), 100,
                                                  k0_tv_value=jnp.float32(0.3), **kw)
        return [sc[k] for k in sorted(sc)] + [jnp.asarray(w[k], jnp.float32) for k in sorted(w)] + [total, psnr]

    def tf(*vals):
        o = dict(zip(names, vals), mask=T(out["mask"]))
        sc, w, total, psnr = tobj_l.object_losses(o, T(target), T(mask), 37, 100, k0_tv_value=torch.tensor(0.3), **kw)
        return [sc[k] for k in sorted(sc)] + [torch.as_tensor(w[k], dtype=torch.float32) for k in sorted(w)] + [total, psnr]

    used = [i for i, k in enumerate(names)
            if use_deform or k not in ("grad_deform", "sdf_correct", "sdf_deform")]
    check(jf, tf, [out[k] for k in names], grad_argnums=tuple(used))
    np.testing.assert_allclose(tobj_l.dynamic_weight(0.1, 1e-3, 37, 100),
                               float(jobj_l.dynamic_weight(0.1, 1e-3, jnp.float32(37.0), 100)), rtol=1e-6)
    check(lambda a, b, m: jobj_l.rendering_loss(a, b, m), lambda a, b, m: tobj_l.rendering_loss(a, b, m),
          [out["rgb_marched"], target, mask], grad_argnums=(0,))


def test_grid_losses():
    jp, tp, jc, tc = _object_state(seed=6)
    sdf, k0 = np.asarray(jp["sdf_grid"]), np.asarray(jp["k0_grid"])
    check(lambda s: jobj_l.shell_positivity_loss(s, 0.3), lambda s: tobj_l.shell_positivity_loss(s, 0.3),
          [sdf], grad_argnums=(0,))
    check(lambda k: jobj_l.k0_total_variation({"k0_grid": k}), lambda k: tobj_l.k0_total_variation({"k0_grid": k}),
          [k0], grad_argnums=(0,))
    mask = np.random.default_rng(16).random(sdf.shape) < 0.7
    for m in (None, mask):
        kw = dict(sdf_tv=0.1, smooth_grad_tv=0.05, weight_tv_density=0.005)
        check(lambda s: jobj_l.object_tv_losses({"sdf_grid": s}, jc, None if m is None else jnp.asarray(m), **kw),
              lambda s: tobj_l.object_tv_losses({"sdf_grid": s}, tc, None if m is None else T(m), **kw),
              [sdf], grad_argnums=(0,), atol=1e-7)
    assert tobj_l.object_tv_losses({"sdf_grid": T(sdf)}, tc).item() == 0.0
    np.testing.assert_array_equal(tobj_l._tv_smooth_kernel("cpu").numpy(), np.asarray(jobj_l._tv_smooth_kernel()))
    # |x|'(0) = +1 as in the reference: the all-zero k0 grid has a non-zero TV gradient
    z = torch.zeros((2, 3, 3, 3), requires_grad=True)
    tobj_l.k0_total_variation({"k0_grid": z}).backward()
    jz = jax.grad(lambda k: jobj_l.k0_total_variation({"k0_grid": k}))(jnp.zeros((2, 3, 3, 3)))
    assert z.grad.abs().sum() > 0
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(jz), rtol=1e-6)


@pytest.mark.parametrize("use_deform", [False, True])
@pytest.mark.parametrize("inverse_y", [True, False])
def test_projection_error_loss(use_deform, inverse_y):
    jp, tp, jc, tc = _object_state(seed=7)
    data = jsyn.make_synthetic_scene(n_train=3, n_test=1, H=32, W=32, seed=0, n_matches=24)
    scale = 0.5 / float(data.xyz_max[0])          # bring the cameras to this test's box
    poses = np.array(data.poses_gt_w2c[:3])
    poses[:, :, 3] *= scale
    pack = np.array(data.obj_matches[1])
    pack[::5, 4] = 0.0                            # padding rows
    Ks = np.asarray(data.Ks[:3])
    HW = None if inverse_y else (32, 32)
    kw = dict(global_step=30, inverse_y=inverse_y, use_deform=use_deform, pixel_thre=200.0,
              near=0.2, far=4.0, HW=HW)

    def jf(pose, p):
        return jproj.projection_error_loss(p, jc, pose, jnp.asarray(Ks), jnp.asarray(pack[:, 0:2]),
                                           jnp.asarray(pack[:, 2:4]), jnp.asarray(pack[:, 4]), 0, 1, **kw)

    jout = jf(jnp.asarray(poses), jp)
    jg = jax.grad(lambda pose, p: sum(jf(pose, p)), argnums=(0, 1))(jnp.asarray(poses), jp)
    leaves = [x.requires_grad_(True) for x in jax.tree.leaves(tp)]
    tpose = T(poses, True)
    tout = tproj.projection_error_loss(tp, tc, tpose, T(Ks), T(pack[:, 0:2]), T(pack[:, 2:4]), T(pack[:, 4]),
                                       0, 1, **kw)
    for a, b in zip(jout, tout):
        np.testing.assert_allclose(b.item(), float(a), rtol=1e-4, atol=1e-6)
    if inverse_y:
        assert float(jout[0]) > 0
    tg = torch.autograd.grad(tout[0] + tout[1], leaves + [tpose], allow_unused=True)
    tg = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves + [tpose], tg)]
    # rtol 1e-3 and a floor of 1e-8: the scalars sdf_alpha and sdf_beta collect
    # near-cancelling sums over every sample of every matched ray
    _assert_tree_grads(tg[:-1], jg[1], rtol=1e-3, floor=1e-8)
    _assert_tree_grads(tg[-1:], [jg[0]], rtol=1e-3, floor=1e-8)
    # the near-surface prior's "center" is xyz_min + xyz_max (no /2), as in the reference
    off = tobj.ObjectConfig(**{**OC, "xyz_min": (-0.5, -0.5, -0.5), "xyz_max": (0.7, 0.5, 0.5)})
    o, d = T(np.array([[2.0, 0.0, 0.0]], np.float32)), T(np.array([[0.0, 1.0, 0.0]], np.float32))
    centre = T(off.xyz_min_np + off.xyz_max_np)
    assert tgeo.point_to_ray_distance(o, d, centre).item() == pytest.approx(1.8)


# ---------------------------------------------------------------- batching and the optimizer


@pytest.mark.parametrize("inverse_y", [True, False])
def test_sample_object_batch(inverse_y):
    data = jsyn.make_synthetic_scene(n_train=3, n_test=1, H=32, W=32, seed=0, n_matches=16)
    key = jax.random.PRNGKey(4)
    n_rand, n_active = 64, 2
    poses = np.asarray(data.poses_gt_w2c[:3])
    jb = jbatch.sample_object_batch(key, n_rand, n_active, jnp.asarray(data.images[:3]), jnp.asarray(data.masks[:3]),
                                    jnp.asarray(data.Ks[:3]), jnp.asarray(poses), jnp.asarray(data.samplers.pixels),
                                    jnp.asarray(data.samplers.counts), inverse_y)
    k_view, k_class, k_pix = jax.random.split(key, 3)
    draws = {"view": T(jax.random.randint(k_view, (n_rand,), 0, n_active)).long(),
             "cls": T(jax.random.choice(k_class, 3, (n_rand,), p=jnp.asarray(jbatch.SEMANTIC_FRACS))).long(),
             "pick": T(jax.random.uniform(k_pix, (n_rand,)))}
    tb = tbatch.sample_object_batch(draws, T(data.images[:3]), T(data.masks[:3]), T(data.Ks[:3]), T(poses),
                                    T(data.samplers.pixels).long(), T(data.samplers.counts).long(), inverse_y)
    assert tbatch.SEMANTIC_FRACS == jbatch.SEMANTIC_FRACS
    for a, b in zip(jb, tb):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)
    own = tbatch.draw_object_batch(torch.Generator().manual_seed(0), 4000, 3, "cpu")
    assert own["view"].max() == 2 and own["cls"].max() == 2 and 0 <= own["pick"].min() and own["pick"].max() < 1
    np.testing.assert_allclose(np.bincount(own["cls"].numpy()) / 4000, jbatch.SEMANTIC_FRACS, atol=0.03)


@pytest.mark.parametrize("frozen", [(), ("lrate_k0", "lrate_warpnet")])
def test_object_optimizer_matches_optax_over_the_lr_drops(frozen):
    """Ten updates each at counts 0, 4995 (across the 5000 drop) and 9995
    (across the 10000 drop) on the same random gradients."""
    over = {k: 0.0 for k in frozen}
    jopt = joptim.build_object_optimizer(jcfg.ObjectTrainConfig(**over))
    topt = toptim.ObjectOptimizer(tcfg.ObjectTrainConfig(**over))
    rng = np.random.default_rng(17)
    params = {"sdf_grid": rng.normal(size=(1, 3, 3, 3)), "k0_grid": rng.normal(size=(2, 3, 3, 3)),
              "rgbnet": [{"w": rng.normal(size=(4, 3)), "b": rng.normal(size=3)}],
              "warpnet": {"layers": [{"w": rng.normal(size=(3, 4)), "b": rng.normal(size=4)}],
                          "output_range": np.asarray(0.9)},
              "sdf_alpha": np.asarray(10.0), "sdf_beta": np.asarray(2.0), "s_val": np.asarray(0.2)}
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jparams)
    tstate = topt.init(convert.tree_from_numpy(params, "cpu"))
    assert set(tstate["mu"]) == set(params) - {"s_val"} - {{"lrate_k0": "k0_grid", "lrate_warpnet": "warpnet"}[f]
                                                           for f in frozen}
    update = jax.jit(jopt.update)
    for start in (0, 4995, 9995):
        jstate = jax.tree.map(lambda x: jnp.asarray(start, x.dtype) if x.dtype == jnp.int32 else x, jstate)
        tstate = dict(tstate, count=start)
        for i in range(10):
            grads = jax.tree.map(lambda a: rng.normal(0, 10.0 ** rng.integers(-4, 1), a.shape).astype(np.float32), params)
            jup, jstate = update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
            tup, tstate = topt.update(convert.tree_from_numpy(grads, "cpu"), tstate)
            assert jax.tree.structure(_np(jup)) == jax.tree.structure(convert.tree_to_numpy(tup))
            for a, b in zip(jax.tree.leaves(_np(jup)), jax.tree.leaves(convert.tree_to_numpy(tup))):
                np.testing.assert_allclose(b, a, rtol=2e-5, atol=1e-9)
            carried = convert.object_adam_state_from_jax(_np(jstate), "cpu")
            assert carried["count"] == tstate["count"] == start + i + 1
            for a, b in zip(jax.tree.leaves(convert.tree_to_numpy(carried["mu"])),
                            jax.tree.leaves(convert.tree_to_numpy(tstate["mu"]))):
                # an element where (1-b1) g and b1 mu nearly cancel keeps only
                # the absolute accuracy of its terms
                np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6 * np.abs(a).max())
    # frozen modules and s_val get zero updates; output_range is trained with warpnet
    assert not np.asarray(jup["s_val"]).any() and not tup["s_val"].any()
    if "lrate_warpnet" not in frozen:
        assert tup["warpnet"]["output_range"].abs() > 0 and abs(float(jup["warpnet"]["output_range"])) > 0
    else:
        assert not tup["warpnet"]["output_range"].any() and not tup["k0_grid"].any()
    assert topt.lr("sdf_grid", 10000) == pytest.approx(0.1 * 0.1 * 0.1 * 0.5, rel=1e-5)
    if not frozen:
        assert topt.lr("k0_grid", 10000) == pytest.approx(0.1 * 0.1, rel=1e-5)
