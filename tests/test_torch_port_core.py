"""Parity of the PyTorch port's core, ops, losses, batching, optimizers and data
with the JAX package, at float32 on the CPU.

Each case feeds the same numpy inputs (from a seed) to the JAX function and
its port and compares the values and, where the function is differentiable,
the vector-Jacobian product with one random cotangent: rtol 1e-5 and atol
1e-5 unless a case states otherwise. Random draws the JAX functions make
from keys are rebuilt with `jax.random` and handed to the port as tensors.
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from poseprobe_tpu.config import config as jcfg
from poseprobe_tpu.core import geometry as jgeo, lie as jlie, pose as jpose, rays as jrays
from poseprobe_tpu.data import synthetic as jsyn
from poseprobe_tpu.losses import common as jcommon, scene as jscene_l
from poseprobe_tpu.models import scene_nerf as jnerf
from poseprobe_tpu.ops import compositing as jcomp, pe as jpe, ray_sampling as jrs
from poseprobe_tpu.train import batching as jbatch, optim as joptim
from poseprobe_tpu_torch import convert
from poseprobe_tpu_torch.config import config as tcfg
from poseprobe_tpu_torch.core import geometry as tgeo, lie as tlie, pose as tpose, rays as trays
from poseprobe_tpu_torch.data import synthetic as tsyn
from poseprobe_tpu_torch.losses import common as tcommon, scene as tscene_l
from poseprobe_tpu_torch.models import scene_nerf as tnerf
from poseprobe_tpu_torch.ops import compositing as tcomp, pe as tpe, ray_sampling as trs
from poseprobe_tpu_torch.train import batching as tbatch, optim as toptim

torch.set_num_threads(1)

RTOL = ATOL = 1e-5


def _flat(out):
    if isinstance(out, dict):
        return [x for k in sorted(out) for x in _flat(out[k])]
    if isinstance(out, (tuple, list)):
        return [x for v in out for x in _flat(v)]
    return [out]


def check(jfn, tfn, inputs, grad_argnums=(), rtol=RTOL, atol=ATOL, seed=0):
    """Compare values, and the VJP w.r.t. `grad_argnums` with a random cotangent."""
    j_out = _flat(jax.jit(jfn)(*[jnp.asarray(x) for x in inputs]))
    t_in = [torch.tensor(x, requires_grad=i in grad_argnums) for i, x in enumerate(inputs)]
    t_out = _flat(tfn(*t_in))
    assert len(j_out) == len(t_out)
    for a, b in zip(j_out, t_out):
        np.testing.assert_allclose(b.detach().numpy().astype(np.float64),
                                   np.asarray(a, np.float64), rtol=rtol, atol=atol)
    if not grad_argnums:
        return
    rng = np.random.default_rng(seed + 1)
    cots = [rng.normal(0, 1, np.shape(a)).astype(np.float32) for a in j_out
            if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating)]

    def jscalar(*args):
        outs = [o for o in _flat(jfn(*args)) if jnp.issubdtype(o.dtype, jnp.floating)]
        return sum((o * c).sum() for o, c in zip(outs, cots))

    j_grads = jax.jit(jax.grad(jscalar, argnums=tuple(grad_argnums)))(*[jnp.asarray(x) for x in inputs])
    outs = [o for o in t_out if o.dtype.is_floating_point]
    total = sum((o * torch.tensor(c)).sum() for o, c in zip(outs, cots))
    t_grads = torch.autograd.grad(total, [t_in[i] for i in grad_argnums])
    for a, b in zip(j_grads, t_grads):
        np.testing.assert_allclose(b.numpy().astype(np.float64), np.asarray(a, np.float64),
                                   rtol=max(rtol, 1e-4), atol=max(atol, 1e-5))


def _rand(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(0, scale, shape)).astype(np.float32)


def _rot_pose(n, seed=0):
    """Well-conditioned w2c poses [n, 3, 4] from small se3 vectors."""
    return np.asarray(jlie.se3_to_SE3(jnp.asarray(_rand((n, 6), seed, 0.3))))


def _K(n=1, f=30.0, c=16.0):
    return np.tile(np.array([[f, 0, c], [0, f, c], [0, 0, 1]], np.float32), (n, 1, 1))


# --------------------------------------------------------------------- core

CORE_CASES = {
    "skew": (jlie.skew, tlie.skew, lambda: [_rand((4, 3))], (0,)),
    "so3_to_SO3": (jlie.so3_to_SO3, tlie.so3_to_SO3, lambda: [_rand((5, 3), 1, 0.5)], (0,)),
    "so3_to_SO3_at_zero": (jlie.so3_to_SO3, tlie.so3_to_SO3, lambda: [np.zeros((2, 3), np.float32)], (0,)),
    "se3_to_SE3": (jlie.se3_to_SE3, tlie.se3_to_SE3, lambda: [_rand((5, 6), 2, 0.5)], (0,)),
    "se3_to_SE3_at_zero": (jlie.se3_to_SE3, tlie.se3_to_SE3, lambda: [np.zeros((3, 6), np.float32)], (0,)),
    "invert": (jpose.invert, tpose.invert, lambda: [_rot_pose(3)], (0,)),
    "compose_pair": (jpose.compose_pair, tpose.compose_pair, lambda: [_rot_pose(3, 1), _rot_pose(3, 2)], (0, 1)),
    "invert_4x4": (lambda p: jpose.invert_4x4(jpose.pad(p)), lambda p: tpose.invert_4x4(tpose.pad(p)),
                   lambda: [_rot_pose(2, 3)], (0,)),
    "world2cam": (jpose.world2cam, tpose.world2cam, lambda: [_rand((2, 7, 3), 4), _rot_pose(2, 5)], (0, 1)),
    "cam2img": (jpose.cam2img, tpose.cam2img, lambda: [_rand((2, 7, 3), 6), _K(2)], (0,)),
    "img2cam": (jpose.img2cam, tpose.img2cam, lambda: [_rand((2, 7, 3), 7), _K(2)], (0,)),
    "to_hom": (jpose.to_hom, tpose.to_hom, lambda: [_rand((4, 3), 8)], (0,)),
    "center_and_ray_at_pixels": (jrays.get_center_and_ray_at_pixels, trays.get_center_and_ray_at_pixels,
                                 lambda: [_rot_pose(2, 9), _rand((2, 6, 2), 10, 8.0) + 16, _K(2)], (0, 1)),
    "points_from_depth": (lambda c, r, d: jrays.get_3d_points_from_depth(c, r, d, multi_samples=True),
                          lambda c, r, d: trays.get_3d_points_from_depth(c, r, d, multi_samples=True),
                          lambda: [_rand((1, 4, 3), 11), _rand((1, 4, 3), 12), _rand((1, 4, 5, 1), 13)], (0, 1, 2)),
    "project_to_other_img": (
        lambda k, d, T: jgeo.batch_project_to_other_img(k, d, jnp.asarray(_K()[0]), jnp.asarray(_K(f=28)[0]),
                                                        T, return_depth=True),
        lambda k, d, T: tgeo.batch_project_to_other_img(k, d, torch.tensor(_K()[0]), torch.tensor(_K(f=28)[0]),
                                                        T, return_depth=True),
        lambda: [_rand((6, 2), 14, 8.0) + 16, 2 + np.abs(_rand(6, 15)), np.asarray(jpose.pad(_rot_pose(1, 16)[0]))],
        (0, 1, 2)),
    "backproject_to_3d": (
        lambda k, d, T: jgeo.batch_backproject_to_3d(k, d, jnp.asarray(_K()[0]), T),
        lambda k, d, T: tgeo.batch_backproject_to_3d(k, d, torch.tensor(_K()[0]), T),
        lambda: [_rand((6, 2), 17, 8.0) + 16, 2 + np.abs(_rand(6, 18)), np.asarray(jpose.pad(_rot_pose(1, 19)[0]))],
        (0, 1, 2)),
    "project": (
        lambda x, T: jgeo.batch_project(x, T, jnp.asarray(_K()[0]), return_depth=True),
        lambda x, T: tgeo.batch_project(x, T, torch.tensor(_K()[0]), return_depth=True),
        lambda: [_rand((6, 3), 20) + np.array([0, 0, 4], np.float32), np.asarray(jpose.pad(_rot_pose(1, 21)[0]))],
        (0, 1)),
}


@pytest.mark.parametrize("name", sorted(CORE_CASES))
def test_core(name):
    jfn, tfn, make, argnums = CORE_CASES[name]
    check(jfn, tfn, make(), argnums)


# ---------------------------------------------------------------------- ops

OPS_CASES = {
    "barf_weights": (lambda p: jpe.barf_weights(p, 6, (0.1, 0.5)),
                     lambda p: tpe.barf_weights(p, 6, (0.1, 0.5), device="cpu"),
                     lambda: [np.float32(0.27)], ()),
    "posenc_scene": (lambda x: jpe.posenc_scene(x, 4, 0.3, (0.1, 0.5)),
                     lambda x: tpe.posenc_scene(x, 4, 0.3, (0.1, 0.5)), lambda: [_rand((2, 5, 3), 22)], (0,)),
    "posenc_scene_no_c2f": (lambda x: jpe.posenc_scene(x, 3, 0.3, None, add_raw=False),
                            lambda x: tpe.posenc_scene(x, 3, 0.3, None, add_raw=False),
                            lambda: [_rand((7, 3), 23)], (0,)),
    "sample_depth_to_max": (lambda d: jrs.sample_depth_to_max(1, 4, 8, 0.5, d),
                            lambda d: trs.sample_depth_to_max(1, 4, 8, 0.5, d),
                            lambda: [2 + np.abs(_rand((1, 4), 24))], (0,)),
    "merge_sorted_depths": (jrs.merge_sorted_depths, trs.merge_sorted_depths,
                            lambda: [np.sort(_rand((2, 3, 9), 25), -1)[..., None],
                                     np.sort(_rand((2, 3, 7), 26), -1)[..., None]], ()),
    "alpha2weights": (jcomp.alpha2weights, tcomp.alpha2weights,
                      lambda: [np.random.default_rng(27).uniform(0, 0.6, (4, 24)).astype(np.float32)], (0,)),
    "nerf_composite": (jcomp.nerf_composite, tcomp.nerf_composite,
                       lambda: [np.random.default_rng(28).uniform(0, 1, (1, 3, 9, 3)).astype(np.float32),
                                np.abs(_rand((1, 3, 9), 29)),
                                np.sort(np.random.default_rng(30).uniform(0.5, 4, (1, 3, 9)), -1)[..., None]
                                .astype(np.float32), _rand((1, 3, 3), 31)], (0, 1, 2, 3)),
}


@pytest.mark.parametrize("name", sorted(OPS_CASES))
def test_ops(name):
    jfn, tfn, make, argnums = OPS_CASES[name]
    check(jfn, tfn, make(), argnums)


@pytest.mark.parametrize("jittered", [False, True])
def test_sample_depth_stratified_and_pdf(jittered):
    key = jax.random.PRNGKey(3)
    kc, kf = jax.random.split(key)
    rng_c, rng_f = (kc, kf) if jittered else (None, None)
    d_j = jrs.sample_depth_stratified(rng_c, 1, 5, 12, 0.5, 6.0)
    w = np.abs(_rand((1, 5, 12), 32))
    f_j = jrs.sample_depth_from_pdf(rng_f, jnp.asarray(w), 12, 10, 0.5, 6.0)
    jitter = torch.tensor(np.asarray(jax.random.uniform(kc, (1, 5, 12, 1)))) if jittered else None
    grid = torch.tensor(np.asarray(jnp.sort(jax.random.uniform(kf, (11,))))) if jittered else None
    d_t = trs.sample_depth_stratified(jitter, 1, 5, 12, 0.5, 6.0, device="cpu")
    f_t = trs.sample_depth_from_pdf(grid, torch.tensor(w), 12, 10, 0.5, 6.0)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------------- losses

SC = jcfg.SceneTrainConfig()


def _render_out(seed):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0.5, 4, (2, 8, 6)), -1)[..., None].astype(np.float32)
    return {"rgb": rng.uniform(0, 1, (2, 8, 3)).astype(np.float32),
            "rgb_fine": rng.uniform(0, 1, (2, 8, 3)).astype(np.float32),
            "depth": rng.uniform(1, 3, (2, 8, 1)).astype(np.float32),
            "depth_fine": rng.uniform(1, 3, (2, 8, 1)).astype(np.float32),
            "weights": rng.uniform(0, 0.3, (2, 8, 6, 1)).astype(np.float32), "t": t}


LOSS_CASES = {
    "huber": (lambda d: jcommon.huber(d, 0.5), lambda d: tcommon.huber(d, 0.5), lambda: [_rand(50, 33)], (0,)),
    "compute_diff_loss_masked": (
        lambda d, w, m: jcommon.compute_diff_loss("huber", d, weights=w, mask=m),
        lambda d, w, m: tcommon.compute_diff_loss("huber", d, weights=w, mask=m),
        lambda: [_rand((9, 2), 34, 3.0), np.abs(_rand((9, 1), 35)), (_rand((9, 1), 36) > 0).astype(np.float32)],
        (0, 1)),
    "compute_diff_loss_epe": (lambda d: jcommon.compute_diff_loss("epe", d),
                              lambda d: tcommon.compute_diff_loss("epe", d), lambda: [_rand((9, 2), 37) + 3], (0,)),
    "mse2psnr": (jcommon.mse2psnr, tcommon.mse2psnr, lambda: [np.float32(0.013)], (0,)),
    "summarize_losses": (
        lambda a, b: jcommon.summarize_losses({"render": a, "corres": b, "fg_mask": a}, SC.loss_weight_dict()),
        lambda a, b: tcommon.summarize_losses({"render": a, "corres": b, "fg_mask": a}, SC.loss_weight_dict()),
        lambda: [np.float32(0.3), np.float32(2.5)], (0, 1)),
    "photometric_and_regu": (
        lambda rgb, rgbf, d, df, tgt: jscene_l.photometric_and_regu_loss(
            {"rgb": rgb, "rgb_fine": rgbf, "depth": d, "depth_fine": df}, tgt, SC),
        lambda rgb, rgbf, d, df, tgt: tscene_l.photometric_and_regu_loss(
            {"rgb": rgb, "rgb_fine": rgbf, "depth": d, "depth_fine": df}, tgt, SC),
        lambda: [_render_out(38)[k] for k in ("rgb", "rgb_fine", "depth", "depth_fine")]
        + [np.random.default_rng(39).uniform(0, 1, (2, 8, 3)).astype(np.float32)], (0, 1, 2, 3)),
    "distortion": (jscene_l.distortion_loss, tscene_l.distortion_loss,
                   lambda: [_render_out(40)["t"], _render_out(40)["weights"]], (1,)),
    "correspondence_pair_rays": (
        lambda p, a, b: jscene_l.correspondence_pair_rays(p, jnp.asarray(_K(3)), a, b, 2, 1),
        lambda p, a, b: tscene_l.correspondence_pair_rays(p, torch.tensor(_K(3)), a, b, 2, 1),
        lambda: [_rot_pose(3, 41), _rand((5, 2), 42, 8) + 16, _rand((5, 2), 43, 8) + 16], (0,)),
    "interpolate_pose_toward": (
        lambda p, w: jscene_l.interpolate_pose_toward(jpose.invert_4x4(jpose.pad(p)), 1, w),
        lambda p, w: tscene_l.interpolate_pose_toward(tpose.invert_4x4(tpose.pad(p)), 1, w),
        lambda: [_rot_pose(3, 44), np.float32(0.37)], (0, 1)),
}


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_losses(name):
    jfn, tfn, make, argnums = LOSS_CASES[name]
    check(jfn, tfn, make(), argnums)


@pytest.mark.parametrize("fine,iteration", [(False, 3), (True, 12000)])
def test_correspondence_loss_from_depths(fine, iteration):
    K = _K(3)
    conf = np.ones(6, np.float32)
    conf[-1] = 0.0

    def j(poses, d, df, ps, po):
        return jscene_l.correspondence_loss_from_depths(d, df if fine else None, poses, jnp.asarray(K), ps, po,
                                                        jnp.asarray(conf), 0, 1, iteration, SC)

    def t(poses, d, df, ps, po):
        return tscene_l.correspondence_loss_from_depths(d, df if fine else None, poses, torch.tensor(K), ps, po,
                                                        torch.tensor(conf), 0, 1, iteration, SC)

    check(j, t, [_rot_pose(3, 45), 2 + np.abs(_rand((2, 6), 46)), 2 + np.abs(_rand((2, 6), 47)),
                 _rand((6, 2), 48, 8) + 16, _rand((6, 2), 49, 8) + 16], (0, 1, 2) if fine else (0, 1))


SMALL_SCENE = dict(layers_feat=(32,) * 4, layers_rgb=(16, 3), skip=(2,), L_3D=4, L_view=2,
                   sample_intvs=8, sample_intvs_fine=8, barf_c2f=(0.1, 0.5))


@pytest.mark.parametrize("fine", [False, True])
def test_depth_consistency_from_ref_depth(fine):
    """Depth consistency through real renders (to-max visibility and the
    jittered render) of a small scene NeRF, values and grads w.r.t. the ref
    depth and the scene params."""
    jc, tc = jnerf.SceneConfig(**SMALL_SCENE), tnerf.SceneConfig(**SMALL_SCENE)
    params = jax.tree.map(np.asarray, jnerf.init_scene_params(jax.random.PRNGKey(1), jc))
    poses = np.stack([np.asarray(jpose.invert(jpose.make(
        R=jnp.eye(3), t=jnp.asarray([0.3 * i, 0.0, -2.5])))) for i in range(3)])
    K = _K(3, f=28.0, c=16.0)
    px = np.random.default_rng(50).uniform(6, 26, (10, 2)).astype(np.float32)
    d_ref = np.random.default_rng(51).uniform(2.0, 3.0, 10).astype(np.float32)
    key = jax.random.PRNGKey(7)
    kc, kf = jax.random.split(key)
    noise = {"jitter": torch.tensor(np.asarray(jax.random.uniform(kc, (1, 10, 8, 1)))),
             "fine_grid": torch.tensor(np.asarray(jnp.sort(jax.random.uniform(kf, (9,)))))}
    valid = np.ones(10, bool)
    valid[3] = False

    def jf(p, d):
        return jscene_l.depth_consistency_from_ref_depth(
            p, jc, jnp.asarray(poses), jnp.asarray(K), jnp.asarray(px), d, 0, 0.4, 32, 32, (0.5, 6.0),
            0.35, 100.0, fine, SC, rng=key, ref_valid=jnp.asarray(valid))

    (vj, (gj_p, gj_d)) = jax.jit(jax.value_and_grad(jf, argnums=(0, 1)))(params, jnp.asarray(d_ref))
    tp = jax.tree.map(lambda a: torch.tensor(a, requires_grad=True), params)
    td = torch.tensor(d_ref, requires_grad=True)
    vt = tscene_l.depth_consistency_from_ref_depth(
        tp, tc, torch.tensor(poses), torch.tensor(K), torch.tensor(px), td, 0, torch.tensor(0.4), 32, 32,
        (0.5, 6.0), torch.tensor(0.35), 100.0, fine, SC, noise=noise, ref_valid=torch.tensor(valid))
    vt.backward()
    assert float(vj) > 0
    np.testing.assert_allclose(vt.item(), float(vj), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(gj_d), rtol=1e-3, atol=1e-6)
    # the rgb head does not reach the depth loss: JAX gives zeros, torch no grad
    t_grads = jax.tree.map(lambda t: torch.zeros_like(t) if t.grad is None else t.grad, tp)
    for a, b in zip(jax.tree.leaves(gj_p), jax.tree.leaves(t_grads)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-3, atol=1e-5)


# ----------------------------------------------------------------- batching

def test_dilate_fg_mask_pools_identical():
    masks = (np.random.default_rng(52).uniform(0, 1, (3, 20, 24, 1)) > 0.97).astype(np.float32)
    for a, b in zip(jbatch.dilate_fg_mask_pools(masks, 2), tbatch.dilate_fg_mask_pools(masks, 2)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["random", "center", "fg", "precrop"])
def test_sample_scene_pixels(mode):
    H, W, ps, n_views, rpv = 20, 24, 2, 2, 32
    images = np.random.default_rng(53).uniform(0, 1, (n_views, H, W, 3)).astype(np.float32)
    masks = np.zeros((n_views, H, W, 1), np.float32)
    masks[:, 6:12, 8:14] = 1.0
    pools, counts = jbatch.dilate_fg_mask_pools(masks, ps)
    fg = mode == "fg"
    center = 0.5 if mode == "center" else 0.0
    precrop = mode == "precrop"
    n_fg = 3 if fg else 0
    key = jax.random.PRNGKey(11)
    sb = jbatch.sample_scene_pixels(key, n_views, rpv, H, W, ps, jnp.asarray(images), n_views,
                                    precrop=precrop, center_fraction=center,
                                    fg_pixels=jnp.asarray(pools) if fg else None,
                                    fg_counts=jnp.asarray(counts) if fg else None, n_fg_patches=n_fg)
    n_rand, n_center, n_fg_eff = tbatch._patch_counts(rpv, ps, center, fg, n_fg)
    kx, ky, kc, kf = jax.random.split(key, 4)
    if precrop:
        _, _, ymax, xmax = tbatch._box(H, W, ps, 0.5)
    else:
        ymax, xmax = H - ps - 1, W - ps - 1
    kcx, kcy = jax.random.split(kc)
    _, _, cymax, cxmax = tbatch._box(H, W, ps, 0.5)
    T = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    draws = {"x": T(jax.random.randint(kx, (n_rand,), 0, xmax)), "y": T(jax.random.randint(ky, (n_rand,), 0, ymax)),
             "cx": T(jax.random.randint(kcx, (n_center,), 0, cxmax)),
             "cy": T(jax.random.randint(kcy, (n_center,), 0, cymax)),
             "fg_u": T(jax.random.uniform(kf, (n_views, n_fg_eff)))}
    tb = tbatch.sample_scene_pixels(draws, n_views, H, W, ps, torch.tensor(images), n_views, precrop=precrop,
                                    fg_pixels=torch.tensor(pools) if fg else None,
                                    fg_counts=torch.tensor(counts) if fg else None)
    for a, b in zip(sb, tb):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


# --------------------------------------------------------------- optimizers

def _tree(rng, pose=False):
    if pose:
        return {"se3_refine": rng.normal(0, 1, (3, 6)).astype(np.float32),
                "se3_align_refine": rng.normal(0, 1, (1, 6)).astype(np.float32)}
    return {"nerf": {"feat": [{"w": rng.normal(0, 1, (5, 4)).astype(np.float32),
                               "b": rng.normal(0, 1, 4).astype(np.float32)}]},
            "x": rng.normal(0, 1, (3, 6)).astype(np.float32)}


@pytest.mark.parametrize("which", ["scene_clip_active", "scene_clip_inactive", "pose_single",
                                   "pose_split", "pose_frozen"])
def test_optimizers_match_optax(which):
    rng = np.random.default_rng(54)
    pose = which.startswith("pose")
    params = _tree(rng, pose)
    if which.startswith("scene"):
        sc = jcfg.SceneTrainConfig(max_iter=50)
        j_opt, t_opt = joptim.build_scene_optimizer(sc), toptim.SceneOptimizer(sc)
        gscale = 1.0 if which == "scene_clip_active" else 1e-3
    else:
        ot = jcfg.ObjectTrainConfig(lr_pose=0.0 if which == "pose_frozen" else 1e-3, lr_pose_end=1e-4)
        trans = 6 if which == "pose_split" else None
        j_opt = joptim.build_pose_optimizer(ot, 3, trans)
        t_opt = toptim.PoseOptimizer(tcfg.ObjectTrainConfig(lr_pose=ot.lr_pose, lr_pose_end=1e-4), 3, trans)
        gscale = 1.0
    j_state = j_opt.init(jax.tree.map(jnp.asarray, params))
    t_state = t_opt.init(convert.tree_from_numpy(params, "cpu"))
    for step in range(8):
        grads = jax.tree.map(lambda a: (a * gscale * (step + 1) * 0.3).astype(np.float32), _tree(rng, pose))
        j_up, j_state = j_opt.update(jax.tree.map(jnp.asarray, grads), j_state)
        t_up, t_state = t_opt.update(convert.tree_from_numpy(grads, "cpu"), t_state)
        for a, b in zip(jax.tree.leaves(j_up), jax.tree.leaves(convert.tree_to_numpy(t_up))):
            np.testing.assert_allclose(b, np.asarray(a), rtol=1e-5, atol=1e-9)
    if which != "pose_frozen":
        back = convert.adam_state_to_numpy(t_state)
        carried = convert.adam_state_from_jax(jax.tree.map(np.asarray, j_state), "cpu")
        assert back["count"] == carried["count"] == 8
        for a, b in zip(jax.tree.leaves(back["nu"]), jax.tree.leaves(convert.tree_to_numpy(carried["nu"]))):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-12)


def test_optax_clip_differs_from_clip_grad_norm():
    """The port keeps optax's clip (no +1e-6 in the denominator)."""
    g = {"x": np.full(4, 0.3, np.float32)}
    sc = jcfg.SceneTrainConfig(max_iter=50)
    t_up, _ = toptim.SceneOptimizer(sc).update(convert.tree_from_numpy(g, "cpu"),
                                               toptim.SceneOptimizer(sc).init(convert.tree_from_numpy(g, "cpu")))
    j_up, _ = joptim.build_scene_optimizer(sc).update(
        jax.tree.map(jnp.asarray, g), joptim.build_scene_optimizer(sc).init(jax.tree.map(jnp.asarray, g)))
    np.testing.assert_allclose(t_up["x"].numpy(), np.asarray(j_up["x"]), rtol=1e-6)
    clipped = optax.clip_by_global_norm(0.1).update(jax.tree.map(jnp.asarray, g), None)[0]["x"]
    assert float(jnp.linalg.norm(clipped)) == pytest.approx(0.1, rel=1e-6)


# --------------------------------------------------------------- data, init

@pytest.mark.parametrize("kw", [dict(n_train=3, n_test=1, H=24, W=24, seed=2, n_matches=16),
                                dict(n_train=4, n_test=2, H=20, W=28, seed=5, n_matches=8, probe="sphere",
                                     texture="noise", match_noise_px=0.5, match_outlier_frac=0.2)])
def test_make_synthetic_scene_identical(kw):
    a, b = jsyn.make_synthetic_scene(**kw), tsyn.make_synthetic_scene(**kw)
    for field in ("images", "masks", "Ks", "poses_gt_w2c", "i_train", "i_test", "xyz_min", "xyz_max",
                  "obj_matches", "scene_matches", "pair_j", "ba_matches", "ba_pairs", "depth_gt"):
        np.testing.assert_array_equal(getattr(b, field), getattr(a, field), err_msg=field)
    assert (a.near, a.far) == (b.near, b.far)


def test_scene_params_init_shapes_and_bounds():
    cfg = tnerf.SceneConfig()
    params = tnerf.init_scene_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    ref = jax.tree.map(np.asarray, jnerf.init_scene_params(jax.random.PRNGKey(0), jnerf.SceneConfig()))
    assert jax.tree.structure(jax.tree.map(lambda t: 0, ref)) == jax.tree.structure(
        jax.tree.map(lambda t: 0, convert.tree_to_numpy(params)))
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(convert.tree_to_numpy(params))):
        assert a.shape == b.shape
        assert np.abs(b).max() <= np.abs(a).max() * 1.05 + 1e-7


def test_port_imports_no_jax():
    """Every module of the port imports with jax blocked, and loads no module of
    the JAX package."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import poseprobe_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'poseprobe_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [n for n in sys.modules if n.startswith('poseprobe_tpu') and not n.startswith('poseprobe_tpu_torch')]\n"
        "bad += [n for n in sys.modules if n == 'optax' or n.startswith('jax.')]\n"
        "assert not bad, bad\n"
        "print('ok', ' '.join(sorted(n for n in sys.modules if n.startswith('poseprobe_tpu_torch'))))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
    loaded = set(out.stdout.split()[1:])
    for name in ("ops._build", "ops.layout", "ops.grid", "ops.maskcache", "ops.fused_mlp", "models.deform",
                 "models.object_sdf", "losses.object", "losses.projection", "train.trainer", "train.optim",
                 "train.batching", "convert", "profile_step", "config.config", "data.synthetic",
                 "ops.fused_composite", "core.align", "pose_init.pnp", "pose_init.ba", "pose_init.relpose",
                 "eval.evaluator", "eval.metrics", "eval.vgg_features", "data.png", "data.loaders",
                 "pose_init.matching", "config.presets", "config.presets.dtu_generic", "config.presets.dtu_scan",
                 "config.presets.dtu_scan1", "config.presets.nerf_synthetic", "config.presets.replica_room0",
                 "config.presets.replica_room1", "config.presets.replica_scene", "config.presets.shapenet_car",
                 "config.presets.toy_candy", "config.presets.toy_desk", "config.presets.toy_scene",
                 "train.state", "eval.mesh", "eval.video", "eval.turbo", "eval.dtu_protocol", "utils.vis",
                 "utils.logging", "utils.profiling", "run", "evaluate", "ops.tensorf", "pose_init.superglue",
                 "pose_init.convert", "parallel.mesh", "parallel.multihost", "parallel.grid_tp",
                 "parallel.object_tp", "parallel.collectives"):
        assert f"poseprobe_tpu_torch.{name}" in loaded, name


def test_build_follows_the_headers_a_source_includes(tmp_path, monkeypatch):
    """A library is rebuilt when its source or a csrc/ header the source
    includes (`#include "..."`) is newer than it, and only then; a source
    that does not include the header is left alone. A fake nvcc counts its
    calls."""
    import os
    from poseprobe_tpu_torch.ops import _build
    csrc, build, bin_dir = tmp_path / "csrc", tmp_path / "build", tmp_path / "cuda" / "bin"
    csrc.mkdir()
    bin_dir.mkdir(parents=True)
    (csrc / "shared.cuh").write_text("// helpers\n")
    (csrc / "a.cu").write_text('#include <stdint.h>\n#include "shared.cuh"\n// a kernel\n')
    (csrc / "b.cu").write_text("// a kernel without the header\n")
    calls = tmp_path / "calls.txt"
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\nopen({str(calls)!r}, 'a').write(sys.argv[-1] + '\\n')\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('lib')\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "_CSRC", csrc)
    monkeypatch.setattr(_build, "_BUILD", build)
    assert [f.name for f in _build.inputs("a")] == ["a.cu", "shared.cuh"]

    def built():
        _build.build(("a", "b"))
        names = [os.path.basename(line) for line in calls.read_text().split()] if calls.exists() else []
        calls.write_text("")
        return sorted(names)

    assert built() == ["a.cu", "b.cu"]
    assert built() == []
    earlier = (csrc / "shared.cuh").stat().st_mtime - 10   # the header edited after the build
    os.utime(build / "liba.so", (earlier, earlier))
    os.utime(build / "libb.so", (earlier, earlier))
    os.utime(csrc / "b.cu", (earlier - 10, earlier - 10))
    assert built() == ["a.cu"]
    assert built() == []


def test_build_lock_lets_one_of_two_processes_compile(tmp_path):
    """Two processes that build at once on a clean tree (the ranks of a job):
    one compiles under the lock in build/, the other waits, then finds the
    library up to date and compiles nothing. A fake nvcc counts its calls."""
    import os
    from pathlib import Path
    csrc, build, bin_dir = tmp_path / "csrc", tmp_path / "build", tmp_path / "cuda" / "bin"
    csrc.mkdir()
    bin_dir.mkdir(parents=True)
    (csrc / "k.cu").write_text("// a kernel\n")
    calls = tmp_path / "calls.txt"
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys, time\nopen({str(calls)!r}, 'a').write('call\\n')\n"
                    "time.sleep(1.0)\nopen(sys.argv[sys.argv.index('-o') + 1], 'w').write('lib')\n")
    nvcc.chmod(0o755)
    code = ("from pathlib import Path\nfrom poseprobe_tpu_torch.ops import _build\n"
            f"_build._CSRC, _build._BUILD = Path({str(csrc)!r}), Path({str(build)!r})\n"
            "print(_build.build(('k',)))\n")
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, CUDA_HOME=str(tmp_path / "cuda"), PYTHONPATH=str(root))
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env, cwd=root, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert calls.read_text().count("call") == 1
    assert (build / "libk.so").read_text() == "lib"
