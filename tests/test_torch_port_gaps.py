"""The last single-card paths of the port held against the JAX package on the
CPU: depth consistency from fresh reference pixels (the scene step with the
correspondence term off), the mask cache's even dilation windows, and the
3-D smoothing kernel.

* `depth_consistency_loss` (a reference render at drawn pixels of a drawn
  view, then `depth_consistency_from_ref_depth`) on a small scene NeRF, with
  and without fine sampling: the loss within 1e-5 relative, the gradients to
  the scene params within rtol 1e-3 and an atol of 1e-5 of the largest.
* One mid-phase scene step with `corres` removed from the loss weights,
  against the JAX `JointTrainer` (object phase over) on the JAX step's
  draws: metrics rtol 1e-5; Adam moments, which carry the gradients, rtol
  1e-3 with an atol of 1e-5 of the tree's largest -- a scalar gradient that
  is a sum of cancelling terms is held against the sum of its terms'
  magnitudes that way.
* `build_mask_grid` / `build_mask_grid_mapped` with windows 2-5 on odd and
  even grids, bit for bit (XLA's SAME padding puts an even window's extra
  cell on the high side).
* `gaussian_kernel_3d`, `conv3d_replicate` and `smooth_grad_tv` with a full
  [k, k, k] kernel (with and without a mask): values within 1e-6, gradients
  within 1e-6 abs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseprobe_tpu.config import config as jcfg
from poseprobe_tpu.core import pose as jpose
from poseprobe_tpu.data.synthetic import make_synthetic_scene as j_make
from poseprobe_tpu.losses import scene as jscene_l
from poseprobe_tpu.models import scene_nerf as jnerf
from poseprobe_tpu.models.object_sdf import ObjectConfig
from poseprobe_tpu.ops import grid as jgrid, maskcache as jmc
from poseprobe_tpu.train.trainer import JointTrainer
from poseprobe_tpu_torch import convert
from poseprobe_tpu_torch.config import config as tcfg
from poseprobe_tpu_torch.data.synthetic import make_synthetic_scene as t_make
from poseprobe_tpu_torch.losses import scene as tscene_l
from poseprobe_tpu_torch.models import scene_nerf as tnerf
from poseprobe_tpu_torch.ops import grid as tgrid, maskcache as tmc
from poseprobe_tpu_torch.train.trainer import SceneTrainer
from test_torch_port_core import SC, SMALL_SCENE, _K
from test_torch_port_step import CAM, OT, SCENE, SM, ST, _carry_state, _draws_from_jax, _np

torch.set_num_threads(1)


def _render_draws(key, R: int, n: int, nf: int) -> dict:
    """A render's draws from a JAX key, as `render_rays` splits it."""
    kc, kf = jax.random.split(key)
    return {"jitter": torch.tensor(np.asarray(jax.random.uniform(kc, (1, R, n, 1)))),
            "fine_grid": torch.tensor(np.asarray(jnp.sort(jax.random.uniform(kf, (nf + 1,)))))}


@pytest.mark.parametrize("fine,view", [(False, 0), (True, 2)])
def test_depth_consistency_loss_from_fresh_pixels(fine, view):
    jc, tc = jnerf.SceneConfig(**SMALL_SCENE), tnerf.SceneConfig(**SMALL_SCENE)
    params = jax.tree.map(np.asarray, jnerf.init_scene_params(jax.random.PRNGKey(1), jc))
    poses = np.stack([np.asarray(jpose.invert(jpose.make(
        R=jnp.eye(3), t=jnp.asarray([0.3 * i, 0.05 * i, -2.5])))) for i in range(3)])
    K = _K(3, f=28.0, c=16.0)
    rng = np.random.default_rng(52)
    px = np.stack([rng.random(24) * 30, rng.random(24) * 30], -1).astype(np.float32)
    key = jax.random.PRNGKey(9)
    rng_a, rng_b = jax.random.split(key)

    def jf(p):
        return jscene_l.depth_consistency_loss(
            p, jc, jnp.asarray(poses), jnp.asarray(K), jnp.asarray(px), view, 0.4, 32, 32, (0.5, 6.0), 0.35, 100.0,
            fine, fine, SC, rng=key)

    vj, gj = jax.jit(jax.value_and_grad(jf))(params)
    tp = jax.tree.map(lambda a: torch.tensor(a, requires_grad=True), params)
    vt = tscene_l.depth_consistency_loss(
        tp, tc, torch.tensor(poses), torch.tensor(K), torch.tensor(px), torch.tensor(view), torch.tensor(0.4),
        32, 32, (0.5, 6.0), torch.tensor(0.35), 100.0, fine, fine, SC, noise_ref=_render_draws(rng_a, 24, 8, 8),
        noise=_render_draws(rng_b, 24, 8, 8))
    vt.backward()
    assert float(vj) > 0
    np.testing.assert_allclose(vt.item(), float(vj), rtol=1e-5)
    t_grads = jax.tree.map(lambda t: torch.zeros_like(t) if t.grad is None else t.grad, tp)
    ref = jax.tree.leaves(gj)
    scale = max(float(np.abs(np.asarray(a)).max()) for a in ref)
    for a, b in zip(ref, jax.tree.leaves(t_grads)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-3, atol=1e-5 * scale)


@pytest.fixture(scope="module")
def trainers_without_corres():
    """The scene-step test's trainer pair (`test_torch_port_step.py`) with
    the corres term removed, so depth consistency takes fresh pixels."""
    st = dict(ST, loss_weight=tuple((k, None if k == "corres" else v)
                                    for k, v in tcfg.SceneTrainConfig().loss_weight))
    data, tdata = j_make(**SCENE), t_make(**SCENE)
    m = float(data.xyz_max[0])
    jc = jcfg.ExperimentConfig(
        data=jcfg.DataConfig(near=data.near, far=data.far), camera=jcfg.CameraConfig(**CAM),
        pnp=jcfg.PnPConfig(use_pnp=False),
        object_model=ObjectConfig(xyz_min=(-m,) * 3, xyz_max=(m,) * 3, num_voxels=8 ** 3,
                                  num_voxels_base=8 ** 3, N_iters=0, use_maskcache=False),
        object_train=jcfg.ObjectTrainConfig(**OT), scene_model=jnerf.SceneConfig(**SM),
        scene_train=jcfg.SceneTrainConfig(**st))
    tc = tcfg.ExperimentConfig(
        data=tcfg.DataConfig(near=tdata.near, far=tdata.far), camera=tcfg.CameraConfig(**CAM),
        pnp=tcfg.PnPConfig(use_pnp=False), object_train=tcfg.ObjectTrainConfig(**OT),
        scene_model=tnerf.SceneConfig(**SM), scene_train=tcfg.SceneTrainConfig(**st))
    return JointTrainer(jc, data), SceneTrainer(tc, tdata, device="cpu")


def _fresh_draws(jt, rng, flags):
    """`_draws_from_jax` without the corres pair, plus the fresh-pixel draws
    from key 7: (view, x, y, interp_w, render key), the render key split in
    two for the reference render and the render at the unseen pose."""
    draws = _draws_from_jax(jt, rng, flags)
    sm = jt.cfg.scene_model
    kp, kx, ky, kw, kr = jax.random.split(jax.random.split(rng, 10)[7], 5)
    n_ref = max(256, sm.rand_rays)
    n_main = draws["render"]["jitter"].shape[1] - 2 * jt.scene_matches.shape[1]
    draws["render"]["jitter"] = draws["render"]["jitter"][:, :n_main]
    ka, kb = jax.random.split(kr)
    draws.update(
        dc_view=torch.tensor(int(jax.random.randint(kp, (), 0, flags["n_active"]))),
        dc_pixels=torch.tensor(np.asarray(jnp.stack([jax.random.uniform(kx, (n_ref,)) * (jt.W - 2),
                                                     jax.random.uniform(ky, (n_ref,)) * (jt.H - 2)], -1))),
        dc_interp_w=torch.tensor(np.asarray(jax.random.uniform(kw, ()))),
        dc_render_ref=_render_draws(ka, n_ref, sm.sample_intvs, sm.sample_intvs_fine),
        dc_render=_render_draws(kb, n_ref, sm.sample_intvs, sm.sample_intvs_fine))
    return draws


def test_mid_step_without_corres_matches_jax(trainers_without_corres):
    jt, tt = trainers_without_corres
    jt.state.step = 40
    _carry_state(jt, tt)
    flags = jt.phase_flags(jt.state.step)
    tflags = tt.phase_flags(tt.global_step)
    assert {k: flags[k] for k in tflags} == tflags and flags["depth_cons_on"] and flags["fine_on"]
    # the port draws the same kinds of numbers itself
    own = tt.sample_draws(tflags)
    assert own["dc_pixels"].shape == (256, 2) and own["dc_render_ref"]["jitter"].shape[1] == 256
    assert "dc_view" in own and float(own["dc_pixels"][:, 0].max()) < tt.W - 2
    rng = jax.random.PRNGKey(4040)
    st = jt.state
    state = (st.obj_params, st.scene_params, st.pose_params, st.opt_obj, st.opt_scene, st.opt_pose, st.poses_pnp)
    new, jm = jt._train_step(state, rng, jnp.asarray(st.step, jnp.int32), None, **flags)
    st.scene_params, st.opt_scene = new[1], new[4]
    tm = tt.step(_fresh_draws(jt, rng, flags))
    assert set(jm) == set(tm) and "loss_corres" not in tm
    for k in jm:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    carried = convert.adam_state_to_numpy(tt.opt_scene_state)
    for moment in ("mu", "nu"):
        ref = jax.tree.leaves(_np(getattr(st.opt_scene[1], moment)))
        scale = max(np.abs(a).max() for a in ref)
        for a, b in zip(ref, jax.tree.leaves(carried[moment])):
            np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-5 * scale, err_msg=moment)


def test_even_dilation_windows_bit_for_bit():
    rng = np.random.default_rng(6)
    for shape in ((1, 8, 7, 9), (1, 6, 6, 6)):
        sdf = rng.normal(size=shape).astype(np.float32)
        for dilate in (2, 3, 4, 5):
            got = tmc.build_mask_grid(torch.tensor(sdf), 0.1, dilate).numpy()
            assert np.array_equal(got, np.asarray(jmc.build_mask_grid(jnp.asarray(sdf), 0.1, dilate))), dilate
            got = tmc.build_mask_grid_mapped(torch.tensor(sdf), 0.2, 3.0, dilate).numpy()
            ref = jmc.build_mask_grid_mapped(jnp.asarray(sdf), 0.2, 3.0, dilate)
            assert np.array_equal(got, np.asarray(ref)), dilate
    # an even window is not a centred one: the extra cell is on the high side
    one = np.full((1, 6, 6, 6), 1.0, np.float32)
    one[0, 3, 3, 3] = -1.0
    m = tmc.build_mask_grid(torch.tensor(one), 0.0, 2).numpy()
    assert m[2:4, 2:4, 2:4].all() and m.sum() == 8


def test_3d_smoothing_kernel():
    rng = np.random.default_rng(7)
    g = rng.normal(size=(3, 7, 6, 5)).astype(np.float32)
    mask = rng.random((1, 7, 6, 5)) < 0.6
    for ksize, sigma in ((3, 0.8), (5, 1.3)):
        jk = jgrid.gaussian_kernel_3d(ksize, sigma)
        tk = tgrid.gaussian_kernel_3d(ksize, sigma, "cpu")
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(tgrid.conv3d_replicate(torch.tensor(g), tk).numpy(),
                                   np.asarray(jgrid.conv3d_replicate(jnp.asarray(g), jk)), rtol=1e-5, atol=1e-6)
        for m in (None, mask):
            jv, jg = jax.value_and_grad(lambda x: jgrid.smooth_grad_tv(
                x, jk, None if m is None else jnp.asarray(m)))(jnp.asarray(g))
            tx = torch.tensor(g, requires_grad=True)
            tv = tgrid.smooth_grad_tv(tx, tk, None if m is None else torch.tensor(m))
            tv.backward()
            np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-5)
            np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)
    # the 1-D path is the separable factor of the same smoothing
    k1 = tgrid.gaussian_kernel_1d(5, 1.3, "cpu")
    np.testing.assert_allclose(tgrid.conv3d_separable_replicate(torch.tensor(g), k1).numpy(),
                               tgrid.conv3d_replicate(torch.tensor(g), tgrid.gaussian_kernel_3d(5, 1.3, "cpu")).numpy(),
                               rtol=1e-5, atol=1e-6)
