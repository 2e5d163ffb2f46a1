"""The TensoRF feature grid of the port (`ops/tensorf.py` and the object
branch's TensoRF backend) held against the JAX package on the CPU.

* `tensorf_sample` values and gradients (to the planes, vectors, mixing
  matrix and points, with points outside the box and exactly on its faces,
  where the coordinate clip splits its gradient), with and without `f_vec`:
  values within 1e-6 abs, gradients within 1e-5 abs.
* `tensorf_to_dense`, `tensorf_total_variation` (and its gradient),
  `tensorf_resize` and the init's shapes and scales.
* One object `render` with a TensoRF k0 on a JAX state carried across by
  `convert`: outputs and parameter gradients at `test_torch_port_object.py`'s
  tolerances (values rtol 1e-5 / atol 2e-5; gradients rtol 1e-4 with an atol
  of 1e-5 of the largest element).
* The joint step with a TensoRF k0 from a JAX trainer's state, on the JAX
  step's draws, at `test_torch_port_joint_step.py`'s tolerances (metrics
  rtol 1e-4, Adam moments rtol 2e-3 + 1e-5 of the largest); the JAX state
  and its Adam moments through a format-v2 file into the port and a port
  file through the JAX package's own reader, leaf for leaf.
* A port `JointTrainer` with `grid_type="tensorf"` through a pg_scale
  doubling (`tensorf_resize`, the optimizer restarted) and a checkpoint round
  trip that resumes bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseprobe_tpu.losses import object as jobj_l
from poseprobe_tpu.models import object_sdf as jobj
from poseprobe_tpu.ops import tensorf as jtf
from poseprobe_tpu.train import state as jstate
from poseprobe_tpu_torch import convert
from poseprobe_tpu_torch.losses import object as tobj_l
from poseprobe_tpu_torch.models import object_sdf as tobj
from poseprobe_tpu_torch.ops import tensorf as ttf
from poseprobe_tpu_torch.train import state as tstate
from test_torch_port_checkpoint import _jax_step, _leaves_by_section, _port_leaves_by_section
from test_torch_port_object import OC, T, _assert_tree_grads, _rays, _scalar

torch.set_num_threads(1)

LO = np.array([-0.5, -0.4, -0.6], np.float32)
HI = np.array([0.5, 0.6, 0.3], np.float32)
KEYS = ("f_vec", "x_vec", "xy_plane", "xz_plane", "y_vec", "yz_plane", "z_vec")


def _params(channels: int, seed: int = 0):
    p = jtf.init_tensorf_params(jax.random.PRNGKey(seed), channels, (7, 6, 5), 4)
    return p, {k: torch.tensor(np.asarray(v), requires_grad=True) for k, v in p.items()}


def _points(n: int = 60, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.uniform(LO - 0.2, HI + 0.2, (n, 3)).astype(np.float32)
    x[0], x[1] = LO, HI                       # corners: every clip at a tie
    x[2, 0], x[3, 1], x[4, 2] = LO[0], HI[1], HI[2]
    return x.reshape(4, n // 4, 3)


@pytest.mark.parametrize("channels", [12, 1], ids=["f_vec", "no_f_vec"])
def test_tensorf_sample_values_and_gradients(channels):
    jp, tp = _params(channels)
    x = _points()
    jv = jtf.tensorf_sample(jp, jnp.asarray(x), jnp.asarray(LO), jnp.asarray(HI))
    tx = torch.tensor(x, requires_grad=True)
    tv = ttf.tensorf_sample(tp, tx, T(LO), T(HI))
    assert tuple(tv.shape) == jv.shape == ((4, 15, 12) if channels > 1 else (4, 15))
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), rtol=0, atol=1e-6)
    w = np.random.default_rng(1).normal(size=jv.shape).astype(np.float32)
    jg = jax.jit(jax.grad(lambda p, x: (jtf.tensorf_sample(p, x, jnp.asarray(LO), jnp.asarray(HI)) * w).sum(),
                          argnums=(0, 1)))(jp, jnp.asarray(x))
    keys = sorted(tp)
    tg = torch.autograd.grad((tv * T(w)).sum(), [tp[k] for k in keys] + [tx])
    for k, g in zip(keys, tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[0][k]), rtol=0, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(tg[-1].numpy(), np.asarray(jg[1]), rtol=0, atol=1e-5)
    # the clip's split gradient at the faces: half of the cotangent passes there
    assert np.abs(tg[-1].numpy()[0, 0]).sum() > 0


def test_to_dense_total_variation_resize_and_init():
    for channels in (12, 1):
        jp, tp = _params(channels, seed=2)
        np.testing.assert_allclose(ttf.tensorf_to_dense(tp).detach().numpy(), np.asarray(jax.jit(jtf.tensorf_to_dense)(jp)),
                                   rtol=1e-6, atol=1e-7)
        jl, jg = jax.jit(jax.value_and_grad(lambda p: jtf.tensorf_total_variation(p)))(
            jax.tree.map(lambda a: a * 8.0, jp))       # both branches of the smooth L1
        tp8 = {k: (v.detach() * 8.0).requires_grad_(True) for k, v in tp.items()}
        tl = ttf.tensorf_total_variation(tp8)
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
        for k, g in zip(sorted(tp8), torch.autograd.grad(tl, [tp8[k] for k in sorted(tp8)], allow_unused=True)):
            ref = np.asarray(jg[k])
            np.testing.assert_allclose(np.zeros_like(ref) if g is None else g.numpy(), ref, rtol=1e-6, atol=1e-6)
        for size in ((13, 11, 9), (4, 3, 2)):
            ours = ttf.tensorf_resize({k: v.detach() for k, v in tp.items()}, size)
            ref = jax.jit(jtf.tensorf_resize, static_argnums=1)(jp, size)
            for k in ref:
                assert tuple(ours[k].shape) == ref[k].shape
                np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), rtol=0, atol=1e-7, err_msg=k)
    # init: the reference's shapes, and its scales (N(0, 0.1^2), f_vec ~ U(-b, b))
    jp = jtf.init_tensorf_params(jax.random.PRNGKey(0), 12, (30, 20, 10), 8)
    tp = ttf.init_tensorf_params(torch.Generator().manual_seed(0), 12, (30, 20, 10), 8, device="cpu")
    assert {k: v.shape for k, v in jp.items()} == {k: tuple(v.shape) for k, v in tp.items()}
    bound = np.sqrt(3.0 / 24)
    assert np.abs(tp["f_vec"].numpy()).max() <= bound and np.abs(tp["f_vec"].numpy()).max() > 0.9 * bound
    for k in KEYS[1:]:
        assert 0.08 < float(tp[k].std()) < 0.12, k
    assert "f_vec" not in ttf.init_tensorf_params(torch.Generator().manual_seed(0), 1, (3, 3, 3), 2, device="cpu")


def test_mask_grid_lookup():
    sdf = np.random.default_rng(3).normal(size=(1, 6, 7, 5)).astype(np.float32)
    x = _points(40, seed=4)
    jm = jtf.mask_grid_lookup(jtf.make_mask_grid(jnp.asarray(sdf), LO, HI, 0.2), jnp.asarray(x))
    tm = ttf.mask_grid_lookup(ttf.make_mask_grid(T(sdf), LO, HI, 0.2), T(x))
    assert np.array_equal(tm.numpy(), np.asarray(jm)) and 0 < int(tm.sum()) < tm.numel()


@pytest.mark.parametrize("use_deform", [False, True])
def test_render_with_a_tensorf_k0_matches_jax(use_deform):
    over = dict(grid_type="tensorf", tensorf_n_comp=4)
    jc, tc = jobj.ObjectConfig(**{**OC, **over}), tobj.ObjectConfig(**{**OC, **over})
    jp = jobj.init_object_params(jax.random.PRNGKey(2), jc)
    rng = np.random.default_rng(2)
    layers = [dict(la) for la in jp["warpnet"]["layers"]]
    layers[-1] = {k: v + jnp.asarray(rng.normal(0, 2e-2, v.shape), jnp.float32) for k, v in layers[-1].items()}
    jp = dict(jp, warpnet=dict(jp["warpnet"], layers=layers),
              sdf_grid=jp["sdf_grid"] + jnp.asarray(rng.normal(0, 0.01, jp["sdf_grid"].shape), jnp.float32))
    assert set(jp["k0_grid"]) == set(KEYS)
    tp = convert.object_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    o, d, v = _rays(40, seed=11)
    key = jax.random.PRNGKey(3)
    jitter = np.asarray(jax.random.uniform(key, (40, 1)))
    kw = dict(use_deform=use_deform, is_train=True, near=0.5, far=8.5, bg=1.0)

    def jloss(p):
        out = jobj.render(p, jc, jnp.asarray(o), jnp.asarray(d), jnp.asarray(v), jnp.float32(30.0), rng=key, **kw)
        return _scalar(out, jnp) + jobj_l.k0_total_variation(p), out

    (jl, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    leaves = [x.requires_grad_(True) for x in jax.tree.leaves(tp)]
    tout = tobj.render(tp, tc, T(o), T(d), T(v), 30, jitter=T(jitter), **kw)
    assert set(tout) == set(jout)
    for k in jout:
        np.testing.assert_allclose(tout[k].detach().numpy(), np.asarray(jout[k]), rtol=1e-5, atol=2e-5, err_msg=k)
    tl = _scalar(tout, torch) + tobj_l.k0_total_variation(tp)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    tg = torch.autograd.grad(tl, leaves, allow_unused=True)
    _assert_tree_grads([torch.zeros_like(p) if g is None else g for p, g in zip(leaves, tg)], jg)
    # the mesh colours sample k0 through the same backend
    pts = rng.uniform(-0.4, 0.4, (50, 3)).astype(np.float32)
    np.testing.assert_allclose(tobj.mesh_color_forward(tp, tc, pts, chunk=32),
                               jobj.mesh_color_forward(jp, jc, pts, chunk=32), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- the trainers


def _tensorf_trainers():
    """The joint-step test's trainer pair (`test_torch_port_joint_step.py`,
    two of three views active) with a TensoRF k0 of 4 components."""
    import test_torch_port_joint_step as js
    from poseprobe_tpu.config import config as jcfg
    from poseprobe_tpu.data.synthetic import make_synthetic_scene as j_make
    from poseprobe_tpu.train.trainer import JointTrainer as JJointTrainer
    from poseprobe_tpu_torch.config import config as tcfg
    from poseprobe_tpu_torch.data.synthetic import make_synthetic_scene as t_make
    from poseprobe_tpu_torch.train.trainer import JointTrainer as TJointTrainer

    cam = dict(incremental=True, fix_first_pose=True, noise=0.02)
    data, tdata = j_make(**js.SCENE), t_make(**js.SCENE)
    m = float(data.xyz_max[0])
    oc = dict(xyz_min=(-m,) * 3, xyz_max=(m,) * 3, num_voxels=12 ** 3, num_voxels_base=12 ** 3, N_iters=50,
              world_bound_scale=1.25, use_maskcache=True, barf_c2f=(0.05, 0.4), grid_type="tensorf",
              tensorf_n_comp=4)
    trainers = []
    for cfg_mod, oc_cls, sc_cls, d, make in ((jcfg, jobj.ObjectConfig, js.JSceneConfig, data, JJointTrainer),
                                             (tcfg, tobj.ObjectConfig, js.TSceneConfig, tdata, None)):
        cfg = cfg_mod.ExperimentConfig(
            data=cfg_mod.DataConfig(near=d.near, far=d.far), camera=cfg_mod.CameraConfig(**cam),
            pnp=cfg_mod.PnPConfig(use_pnp=False), object_model=oc_cls(**oc),
            object_train=cfg_mod.ObjectTrainConfig(**js.OT), scene_model=sc_cls(**js.SM),
            scene_train=cfg_mod.SceneTrainConfig(**js.ST))
        trainers.append(make(cfg, d) if make else TJointTrainer(cfg, d, device="cpu"))
    return trainers


@pytest.fixture(scope="module")
def jax_tensorf():
    """A JAX trainer with a TensoRF k0, one step past its init state (its
    deform net's last layer perturbed off the zero-deformation kink), and the
    port trainer at the same config."""
    import test_torch_port_joint_step as js
    jt, tt = _tensorf_trainers()
    assert set(jt.state.obj_params["k0_grid"]) == set(KEYS)
    jt.state.step = 3
    rng = np.random.default_rng(5)
    obj = dict(jt.state.obj_params)
    layers = [dict(la) for la in obj["warpnet"]["layers"]]
    layers[-1] = {k: v + jnp.asarray(rng.normal(0, 2e-2, v.shape), jnp.float32) for k, v in layers[-1].items()}
    jt.state.obj_params = dict(obj, warpnet=dict(obj["warpnet"], layers=layers))
    _jax_step(jt, jax.random.PRNGKey(11))
    return jt, tt, js


def test_joint_step_with_a_tensorf_k0_matches_jax(jax_tensorf, tmp_path):
    jt, tt, js = jax_tensorf
    # the JAX state through its own v2 file into the port, leaf for leaf
    path = str(tmp_path / "jax.npz")
    jstate.save_checkpoint(path, jt.state, configs={"expname": "x"}, extras=jt.host_extras())
    payload = tstate.load_checkpoint(path)
    assert tstate.grid_type(payload) == "tensorf"
    tstate.restore_state(tt, payload)
    ref, got = _leaves_by_section(jt.state), _port_leaves_by_section(tt)
    for sec in ref:
        assert len(ref[sec]) == len(got[sec]) and all(np.array_equal(a, b) for a, b in zip(ref[sec], got[sec])), sec
    assert set(tt.opt_obj_state["mu"]["k0_grid"]) == set(KEYS)

    # one step on the JAX step's draws
    rng = jax.random.PRNGKey(12)
    flags, jm = _jax_step(jt, rng)
    assert flags == tt.phase_flags(tt.global_step) and flags["object_on"]
    tm = tt.step(js._draws_from_jax(jt, rng, flags))
    assert set(jm) == set(tm)
    for k in set(jm) - {"proj_err"}:     # proj_err: jitted against op by op, see test_torch_port_joint_step.py
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    jo = convert.adam_state_to_numpy(convert.object_adam_state_from_jax(jax.tree.map(np.asarray, jt.state.opt_obj),
                                                                       "cpu"))
    to = convert.adam_state_to_numpy(tt.opt_obj_state)
    assert jo["count"] == to["count"] == 2
    for moment in ("mu", "nu"):
        for key in jo[moment]:
            js._assert_moments(jax.tree.leaves(jo[moment][key]), jax.tree.leaves(to[moment][key]), f"{moment}/{key}")

    # a port file through the JAX package's reader: the same leaves, a JAX state of the same tree
    out = str(tmp_path / "port.npz")
    tstate.save_checkpoint(out, tt, extras=tt.host_extras())
    back = jstate.restore_state(jt.state, jstate.load_checkpoint(out))
    for a, b in zip(jax.tree.leaves(back.obj_params), jax.tree.leaves(convert.tree_to_numpy(tt.obj_params))):
        assert np.array_equal(np.asarray(a), b)
    assert jax.tree.structure(jax.tree.map(np.asarray, back.opt_obj)) == \
        jax.tree.structure(jax.tree.map(np.asarray, jt.state.opt_obj))


def test_tensorf_trainer_through_a_doubling_and_a_checkpoint(tmp_path):
    import test_torch_port_joint_step as js
    from poseprobe_tpu_torch.config import config as tcfg
    from poseprobe_tpu_torch.data.synthetic import make_synthetic_scene
    from poseprobe_tpu_torch.train.trainer import JointTrainer

    data = make_synthetic_scene(**js.SCENE)
    m = float(data.xyz_max[0])
    cfg = tcfg.ExperimentConfig(
        data=tcfg.DataConfig(near=data.near, far=data.far), camera=tcfg.CameraConfig(fix_first_pose=True),
        pnp=tcfg.PnPConfig(use_pnp=False),
        object_model=tobj.ObjectConfig(xyz_min=(-m,) * 3, xyz_max=(m,) * 3, num_voxels=16 ** 3,
                                       num_voxels_base=16 ** 3, N_iters=50, world_bound_scale=1.25,
                                       grid_type="tensorf", tensorf_n_comp=4),
        object_train=tcfg.ObjectTrainConfig(**{**js.OT, "pg_scale": (3,)}),
        scene_model=js.TSceneConfig(**js.SM), scene_train=tcfg.SceneTrainConfig(**js.ST))

    def trainer():
        return JointTrainer(cfg, data, device="cpu")

    tr = trainer()
    small = tr.cfg.object_model.world_size
    assert tuple(tr.obj_params["k0_grid"]["xy_plane"].shape) == (4,) + small[:2]
    tr.fit(3, superstep=2)
    before = [v for k, v in tr.obj_params["k0_grid"].items() if k != "f_vec"]     # f_vec keeps its size
    tr.fit(2, superstep=2)           # the doubling at step 3: tensorf_resize and a fresh optimizer
    big = tr.cfg.object_model.world_size
    k0 = tr.obj_params["k0_grid"]
    assert big > small and tuple(k0["xy_plane"].shape) == (4,) + big[:2] and tuple(k0["z_vec"].shape) == (4, big[2])
    assert int(tr.opt_obj_state["count"]) == 2       # restarted at the doubling, then steps 3 and 4
    # new k0 tensors: a step captured before the doubling no longer holds the state (`StepGraph.holds`)
    assert not any(a is b for a in before for b in tr.state_tensors())
    path = str(tmp_path / "t.npz")
    tstate.save_checkpoint(path, tr, extras=tr.host_extras())
    again = trainer()
    tstate.restore_state(again, tstate.load_checkpoint(path))
    assert again.cfg.object_model.world_size == big
    for a, b in zip(tr.state_tensors(), again.state_tensors()):
        assert torch.equal(a, b)
    ma, mb = tr.fit(2, log_every=1), again.fit(2, log_every=1)
    assert ma == mb and all(np.isfinite(h["loss_total"]) for h in ma)
