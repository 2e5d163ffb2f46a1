"""The port's checkpoints (`train/state.py`, the trainer's host extras) held
against the JAX package's format v2.

* A JAX file loads into the port: params, Adam moments and counts,
  `poses_pnp`, the scalars and the mask extras equal (bit for bit); one joint
  step from that state on the JAX step's draws matches the JAX step, at the
  tolerances of `test_torch_port_joint_step.py` (metrics rtol 1e-4, Adam
  moments rtol 2e-3 + 1e-5 of the tree's largest, poses atol 1e-6).
* A port file loads through the JAX package's own `load_checkpoint` /
  `restore_state` / `restore_host_extras` with equal leaves, and its manifest
  lists the same sections, keypaths, dtypes and shapes, entry for entry, as a
  JAX file of a trainer at the same config (with and without the scene's
  gradient clipping and the pose optimizer, which move optax's chain indices).
* A port run saved and resumed in a fresh trainer reproduces the run without
  the break bit for bit (CPU), in superstep windows, across a pg_scale
  doubling and mask-cache refreshes after the resume, from a state saved after
  another doubling (the restore sets the object voxel count from the file).
* What the JAX trainer's config is after `restore_state` past a doubling: its
  template's shrunk voxel count, not the grid's (the port's restore of the
  same file takes the grid's).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseprobe_tpu.train import state as jstate
from poseprobe_tpu_torch import convert
from poseprobe_tpu_torch.config import config as tcfg
from poseprobe_tpu_torch.core.tree import tree_leaves
from poseprobe_tpu_torch.data.synthetic import make_synthetic_scene as t_make
from poseprobe_tpu_torch.models.object_sdf import ObjectConfig as TObjectConfig
from poseprobe_tpu_torch.models.scene_nerf import SceneConfig as TSceneConfig
from poseprobe_tpu_torch.train import state as tstate
from poseprobe_tpu_torch.train.trainer import JointTrainer as TJointTrainer
from test_torch_port_joint_step import (OT, SCENE, SM, ST, _assert_moments, _draws_from_jax,
                                        _leave_the_init_state, _np, _trainers)

torch.set_num_threads(1)


def _jax_step(jt, rng):
    st = jt.state
    flags = jt.phase_flags(st.step)
    new, metrics = jt._train_step((st.obj_params, st.scene_params, st.pose_params, st.opt_obj, st.opt_scene,
                                   st.opt_pose, st.poses_pnp), rng, jnp.asarray(st.step, jnp.int32), jt.mask_arr,
                                  mask_k=jt._mask_k, **flags)
    (st.obj_params, st.scene_params, st.pose_params, st.opt_obj, st.opt_scene, st.opt_pose, st.poses_pnp) = new
    st.step += 1
    return flags, metrics


def _leaves_by_section(jt_state):
    return {sec: [np.asarray(x) for x in jax.tree.leaves(getattr(jt_state, sec))] for sec in jstate._SECTIONS}


def _port_leaves_by_section(tt):
    return {sec: [convert.leaf_to_numpy(v) for _, v in entries] for sec, entries in tstate._section_entries(tt).items()}


@pytest.fixture(scope="module")
def jax_file(tmp_path_factory):
    """A JAX trainer one step past the init state (Adam counts 1), its v2 file
    and its state's leaves."""
    jt, _ = _trainers(incremental=True)
    jt.state.step = 3
    _leave_the_init_state(jt)
    _jax_step(jt, jax.random.PRNGKey(11))
    path = str(tmp_path_factory.mktemp("ckpt") / "jax.npz")
    jstate.save_checkpoint(path, jt.state, configs={"expname": "x"}, extras=jt.host_extras())
    return jt, path


def test_a_jax_file_loads_into_the_port_and_steps_as_jax_does(jax_file):
    jt, path = jax_file
    _, tt = _trainers(incremental=True)
    tstate.restore_state(tt, tstate.load_checkpoint(path))
    ref = _leaves_by_section(jt.state)
    got = _port_leaves_by_section(tt)
    for sec in jstate._SECTIONS:
        assert len(ref[sec]) == len(got[sec]), sec
        for a, b in zip(ref[sec], got[sec]):
            assert a.shape == b.shape and np.array_equal(a, b), sec
    assert int(tt.opt_obj_state["count"]) == int(tt.opt_scene_state["count"]) == 1
    assert np.array_equal(tt.poses_pnp.numpy(), np.asarray(jt.state.poses_pnp))
    assert (tt.global_step, tt.n_active, tt.best_val) == (jt.state.step, jt.state.n_active, jt.state.best_val)
    assert np.array_equal(tt.mask_arr.numpy(), np.asarray(jt.mask_arr)) and tt._mask_k == jt._mask_k
    assert tt.cfg.object_model.num_voxels == jt.cfg.object_model.num_voxels

    rng = jax.random.PRNGKey(12)
    flags, jm = _jax_step(jt, rng)
    assert flags == tt.phase_flags(tt.global_step) and flags["object_on"] and flags["pose_on"]
    tm = tt.step(_draws_from_jax(jt, rng, flags))
    assert set(jm) | {"maskcache_fill"} == set(tm)          # the mask cache's fill: the port's own metric
    # proj_err: the jitted JAX step and op-by-op evaluation disagree on grazing rays
    # (test_torch_port_joint_step.py); its weight in loss_total is 1e-4, inside the tolerance
    for k in set(jm) - {"proj_err"}:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    st = jt.state
    jobj = convert.adam_state_to_numpy(convert.object_adam_state_from_jax(_np(st.opt_obj), "cpu"))
    tobj = convert.adam_state_to_numpy(tt.opt_obj_state)
    assert jobj["count"] == tobj["count"] == 2
    for moment in ("mu", "nu"):
        for key in jobj[moment]:
            _assert_moments(jax.tree.leaves(jobj[moment][key]), jax.tree.leaves(tobj[moment][key]),
                            f"{moment}/{key}")
        _assert_moments(jax.tree.leaves(_np(getattr(st.opt_scene[1], moment))),
                        jax.tree.leaves(convert.adam_state_to_numpy(tt.opt_scene_state)[moment]), f"scene {moment}")
    for a, b in zip(jax.tree.leaves(_np(st.pose_params)), jax.tree.leaves(convert.tree_to_numpy(tt.pose_params))):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


def _pair_at(ot=None, st=None):
    """(JAX trainer, port trainer) at one config, with nonzero Adam state on
    the port side (two steps on its own draws)."""
    import test_torch_port_joint_step as js
    old = (js.OT, js.ST)
    js.OT, js.ST = dict(OT, **(ot or {})), dict(ST, **(st or {}))
    try:
        jt, tt = _trainers(incremental=True)
    finally:
        js.OT, js.ST = old
    tt.global_step = 3
    tt.fit(2)
    return jt, tt


@pytest.mark.parametrize("ot,st", [({}, {}), ({"lr_pose": 0.0}, {"nerf_gradient_clipping": 0.0})],
                         ids=["clip_and_pose_adam", "no_clip_frozen_poses"])
def test_a_port_file_loads_in_jax_with_the_jax_layout(ot, st, tmp_path):
    jt, tt = _pair_at(ot, st)
    port_path, jax_path = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tstate.save_checkpoint(port_path, tt, configs={"expname": "x"}, extras=tt.host_extras())
    jstate.save_checkpoint(jax_path, jt.state, configs={"expname": "x"}, extras=jt.host_extras())
    ours = json.loads(bytes(np.load(port_path)["__manifest__"]).decode())
    theirs = json.loads(bytes(np.load(jax_path)["__manifest__"]).decode())
    assert list(ours["sections"]) == list(theirs["sections"])
    for sec in theirs["sections"]:
        strip = lambda es: [(e["path"], e["key"], e["dtype"], e["shape"]) for e in es]  # noqa: E731
        assert strip(ours["sections"][sec]) == strip(theirs["sections"][sec]), sec
    if ot.get("lr_pose") == 0.0:
        assert ours["sections"]["opt_pose"] == [] and ours["sections"]["opt_scene"][0]["path"] == "[0].count"
    with open(port_path + ".json") as f:
        assert json.load(f) == {"expname": "x"}

    payload = jstate.load_checkpoint(port_path)
    jt.state = jstate.restore_state(jt.state, payload)
    jt.restore_host_extras(jstate.get_extras(payload))
    ref = _port_leaves_by_section(tt)
    got = _leaves_by_section(jt.state)
    for sec in jstate._SECTIONS:
        assert len(ref[sec]) == len(got[sec]), sec
        for a, b in zip(ref[sec], got[sec]):
            assert np.array_equal(a, b), sec
    assert np.array_equal(np.asarray(jt.state.poses_pnp), tt.poses_pnp.numpy())
    assert (jt.state.step, jt.state.n_active) == (tt.global_step, tt.n_active) == (5, 2)
    assert np.array_equal(np.asarray(jt.mask_arr), tt.mask_arr.numpy()) and jt._mask_k == tt._mask_k


def test_a_v1_pickle_is_refused_by_name(tmp_path):
    import pickle
    path = tmp_path / "v1.pkl"
    path.write_bytes(pickle.dumps({"step": 1}))
    with pytest.raises(ValueError, match="format v1"):
        tstate.load_checkpoint(str(path))


def _resume_trainer():
    data = t_make(**SCENE)
    m = float(data.xyz_max[0])
    cfg = tcfg.ExperimentConfig(
        data=tcfg.DataConfig(near=data.near, far=data.far),
        camera=tcfg.CameraConfig(incremental=True, incremental_step=50, fix_first_pose=True, noise=0.02),
        pnp=tcfg.PnPConfig(use_pnp=False),
        object_model=TObjectConfig(xyz_min=(-m,) * 3, xyz_max=(m,) * 3, num_voxels=16 ** 3,
                                   num_voxels_base=16 ** 3, N_iters=50, world_bound_scale=1.25, use_maskcache=True),
        object_train=tcfg.ObjectTrainConfig(**dict(OT, pg_scale=(4, 8), maskcache_update_every=4)),
        scene_model=TSceneConfig(**SM), scene_train=tcfg.SceneTrainConfig(**ST))
    return TJointTrainer(cfg, data, device="cpu")


def _snapshot(tt):
    return ([t.clone() for t in tt.state_tensors()], tt.generator.get_state().clone(), tt.cfg, tt._k_phase,
            tt._mask_k, tt.n_active, tt.global_step)


def test_resume_reproduces_the_run_bit_for_bit(tmp_path):
    a = _resume_trainer()
    shrunk = a.cfg.object_model.num_voxels
    a.fit(6, log_every=2, superstep=2)
    assert a.cfg.object_model.num_voxels == 2 * shrunk     # past the first doubling (step 4)
    path = str(tmp_path / "last_ckpt.pkl")
    tstate.save_checkpoint(path, a, configs={"expname": "x"}, extras=a.host_extras())
    hist_a = a.fit(6, log_every=2, superstep=2)[-3:]       # the doubling and a refresh at step 8
    assert a.cfg.object_model.num_voxels == a._final_num_voxels

    b = _resume_trainer()
    assert b.cfg.object_model.num_voxels == shrunk
    tstate.restore_state(b, tstate.load_checkpoint(path))
    assert b.cfg.object_model.num_voxels == 2 * shrunk and b.global_step == 6
    hist_b = b.fit(6, log_every=2, superstep=2)
    assert hist_b == hist_a
    sa, sb = _snapshot(a), _snapshot(b)
    assert len(sa[0]) == len(sb[0]) and all(torch.equal(x, y) for x, y in zip(sa[0], sb[0]))
    assert torch.equal(sa[1], sb[1]) and sa[2:] == sb[2:]


def test_jax_restore_past_a_doubling_keeps_the_template_voxel_count(tmp_path):
    """The JAX trainer starts at num_voxels / 2^len(pg_scale); `restore_state`
    takes the grid shapes from the file and leaves the config at the
    template's count, from which the step size, the sample count and the
    mask-cache budget derive. The port's restore of the same file sets the
    count of the grid."""
    import test_torch_port_joint_step as js
    old = js.OT
    js.OT = dict(OT, pg_scale=(2,))
    try:
        jt, tt = _trainers(incremental=True)
        fresh, _ = _trainers(incremental=True)
    finally:
        js.OT = old
    jt.state.step = 2
    jt.maybe_pg_scale(2)
    grid = tuple(jt.state.obj_params["sdf_grid"].shape[1:])
    assert jt.cfg.object_model.world_size == grid
    path = str(tmp_path / "jax.npz")
    jstate.save_checkpoint(path, jt.state, extras=jt.host_extras())
    payload = jstate.load_checkpoint(path)
    fresh.state = jstate.restore_state(fresh.state, payload)
    fresh.restore_host_extras(jstate.get_extras(payload))
    assert tuple(fresh.state.obj_params["sdf_grid"].shape[1:]) == grid
    assert fresh.cfg.object_model.world_size != grid
    assert fresh.cfg.object_model.num_voxels == jt.cfg.object_model.num_voxels // 2
    assert fresh.cfg.object_model.n_samples < jt.cfg.object_model.n_samples

    tstate.restore_state(tt, tstate.load_checkpoint(path))
    assert tt.cfg.object_model.world_size == grid
    assert tt.cfg.object_model.num_voxels == jt.cfg.object_model.num_voxels
    assert tt.cfg.object_model.n_samples == jt.cfg.object_model.n_samples
    assert len(tree_leaves(tt.opt_obj_state["mu"])) > 0
