"""Ray data parallelism of the port (`parallel/mesh.py`, `parallel/multihost.py`,
the trainers' ``mesh=``) held against the JAX package's.

One job of two gloo ranks on the CPU (`torch_port_parallel_ranks.py`, a file
rendezvous, a deadline) runs every rank-side case of this module; the JAX
references run here, on two of the conftest's virtual CPU devices.

* `init_distributed`: its argument resolution with `init_process_group`
  mocked (the cases of `tests/test_multihost.py`, plus the backend rule), and
  one real two-rank init; a mesh's device (`collectives.local_device`: the
  CPU only when asked for).
* `shard_rays` / `unshard_rays` / `replicated`.
* One early-phase joint step of the tiny trainer of
  `test_torch_port_joint_step.py` on two ranks, on the JAX step's draws,
  against `JointTrainer(mesh=make_mesh(jax.devices()[:2]))` at that test's
  tolerances, and against the port's own single-rank step: the loss within
  1e-5 relative and the Adam moments (the gradients: a factor of the world
  size in any of them fails) within rtol 2e-4; the two ranks' states bit for
  bit equal.
* `replicate_state` after the ranks drift; `fit` with supersteps across a
  view activation (gloo windows run eagerly and say so), against the same
  `fit` on one rank; `render_full_image` of the carried state with a shorter
  last chunk and with chunks that do not divide, against the JAX trainer's on
  its two-device mesh.
"""
import datetime
import types
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import torch_port_parallel_ranks as ranks
from poseprobe_tpu.config import config as jcfg
from poseprobe_tpu.data.synthetic import make_synthetic_scene as j_make
from poseprobe_tpu.models.object_sdf import ObjectConfig as JObjectConfig
from poseprobe_tpu.models.scene_nerf import SceneConfig as JSceneConfig
from poseprobe_tpu.parallel.mesh import make_mesh as j_make_mesh
from poseprobe_tpu.train.trainer import JointTrainer as JJointTrainer
from poseprobe_tpu_torch import convert
from poseprobe_tpu_torch.core.tree import tree_leaves
from poseprobe_tpu_torch.parallel import collectives, multihost
from test_torch_port_joint_step import (OT, SCENE, SM, ST, _assert_state_matches, _carry_state,
                                        _draws_from_jax, _leave_the_init_state, _np)

torch.set_num_threads(1)

WORLD = 2
RAYS = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
RAGGED = np.arange(7 * 3, dtype=np.float32).reshape(7, 3)
VALUES = [np.array([1.5, -0.0, np.nan], np.float32), np.array([3, -4], np.int64), np.array([True, False])]
CHUNKS = (300, 333)       # 1024 pixels: a shorter last chunk of 124; chunks of 333 do not divide


def _kw(incremental_step=800):
    m = float(j_make(**SCENE).xyz_max[0])
    return dict(cam=dict(incremental=True, fix_first_pose=True, noise=0.02, incremental_step=incremental_step),
                oc=dict(xyz_min=(-m,) * 3, xyz_max=(m,) * 3, num_voxels=12 ** 3, num_voxels_base=12 ** 3,
                        N_iters=50, world_bound_scale=1.25, use_maskcache=True, barf_c2f=(0.05, 0.4)),
                ot=OT, sm=SM, st=ST, scene=SCENE)


def _jax_trainer(kw, mesh):
    data = j_make(**kw["scene"])
    jc = jcfg.ExperimentConfig(
        data=jcfg.DataConfig(near=data.near, far=data.far), camera=jcfg.CameraConfig(**kw["cam"]),
        pnp=jcfg.PnPConfig(use_pnp=False), object_model=JObjectConfig(**kw["oc"]),
        object_train=jcfg.ObjectTrainConfig(**kw["ot"]), scene_model=JSceneConfig(**kw["sm"]),
        scene_train=jcfg.SceneTrainConfig(**kw["st"]))
    return JJointTrainer(jc, data, mesh=mesh)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The JAX step on a two-device mesh, the port's single-rank step and
    fit, and the two-rank job's results."""
    kw, fit_kw = _kw(), _kw(incremental_step=4)
    jt = _jax_trainer(kw, j_make_mesh(jax.devices()[:WORLD]))
    tt = ranks.tiny_joint_trainer(kw)
    jt.state.step = 3
    _leave_the_init_state(jt)
    _carry_state(jt, tt)
    flags = jt.phase_flags(jt.state.step)
    assert flags == tt.phase_flags(tt.global_step) and flags["object_on"] and flags["n_active"] == 2
    rng = jax.random.PRNGKey(7)
    draws = ranks._n(_draws_from_jax(jt, rng, flags))
    state = ranks.trainer_state(tt)
    cases = {"init": ("init", {}),
             "shard_and_replicate": ("shard_and_replicate", dict(rays=RAYS, ragged=RAGGED, values=VALUES)),
             "dp_step": ("dp_step", dict(kw=kw, state=state, draws=draws)),
             "replicate_after_drift": ("replicate_after_drift", dict(kw=kw)),
             "fit_across_event": ("fit_across_event", dict(kw=fit_kw, start=2, steps=4, superstep=2))}
    cases.update({f"render{c}": ("render_full", dict(kw=kw, state=state, view=0, chunk=c)) for c in CHUNKS})
    outs = ranks.launch(tmp_path_factory.mktemp("ranks"), WORLD, list(cases.values()), timeout_s=300)

    # the references: the JAX renders and step on the mesh, the port's step and fit on one rank
    renders = {c: _np(jt.render_full_image(jt.poses_gt[0], jt.Ks[0], chunk=c)) for c in CHUNKS}
    st = jt.state
    old_obj = _np(st.obj_params)
    new, jm = jt._train_step((st.obj_params, st.scene_params, st.pose_params, st.opt_obj, st.opt_scene,
                              st.opt_pose, st.poses_pnp), rng, jax.numpy.asarray(st.step, jax.numpy.int32),
                             jt.mask_arr, mask_k=jt._mask_k, **flags)
    (st.obj_params, st.scene_params, st.pose_params, st.opt_obj, st.opt_scene, st.opt_pose, st.poses_pnp) = new
    single = {k: v.item() for k, v in tt.step(ranks._t(draws)).items()}
    fit_ref = ranks.tiny_joint_trainer(fit_kw)
    fit_ref.global_step = 2
    hist = fit_ref.fit(4, log_every=2, superstep=2)
    return types.SimpleNamespace(kw=kw, fit_kw=fit_kw, jax_state=st, old_obj=old_obj, jax_renders=renders,
                                 jax_metrics={k: float(v) for k, v in jm.items()}, single=single,
                                 single_state=ranks.trainer_state(tt), fit_hist=hist,
                                 fit_state=ranks.trainer_state(fit_ref),
                                 outs=[{name: o[i] for i, name in enumerate(cases)} for o in outs])


def _loaded(kw, state):
    tr = ranks.tiny_joint_trainer(kw)
    ranks.load_state(tr, state)
    return tr


def _assert_bitwise(a, b):
    assert {k: v for k, v in a.items() if k != "tensors"} == {k: v for k, v in b.items() if k != "tensors"}
    assert len(a["tensors"]) == len(b["tensors"])
    for x, y in zip(a["tensors"], b["tensors"]):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


# ------------------------------------------------------------- multihost

ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@pytest.fixture
def clean_env(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    return monkeypatch


def _call(world_size, rank, init_method=None, backend="gloo"):
    return mock.call(backend=backend, init_method=init_method, world_size=world_size, rank=rank,
                     timeout=datetime.timedelta(seconds=600.0))


def test_single_process_is_noop(clean_env):
    with mock.patch("torch.distributed.init_process_group") as init:
        assert multihost.init_distributed() is False
        assert multihost.init_distributed(world_size=1, rank=0) is False
        init.assert_not_called()


def test_explicit_args_initialize(clean_env):
    with mock.patch("torch.distributed.init_process_group") as init:
        assert multihost.init_distributed("tcp://10.0.0.1:1234", 4, 2) is True
        assert init.call_args_list == [_call(4, 2, "tcp://10.0.0.1:1234")]


def test_env_var_resolution(clean_env):
    for k, v in (("MASTER_ADDR", "head"), ("MASTER_PORT", "9999"), ("WORLD_SIZE", "8"), ("RANK", "5")):
        clean_env.setenv(k, v)
    with mock.patch("torch.distributed.init_process_group") as init:
        assert multihost.init_distributed() is True
        assert init.call_args_list == [_call(8, 5)]      # env:// reads MASTER_ADDR / MASTER_PORT


def test_explicit_args_beat_env(clean_env):
    clean_env.setenv("WORLD_SIZE", "2")
    clean_env.setenv("RANK", "1")
    with mock.patch("torch.distributed.init_process_group") as init:
        assert multihost.init_distributed("tcp://arg:2", 16, 7) is True
        assert init.call_args_list == [_call(16, 7, "tcp://arg:2")]


def test_missing_rank_raises(clean_env):
    with mock.patch("torch.distributed.init_process_group"):
        with pytest.raises(ValueError, match="rank"):
            multihost.init_distributed(world_size=4)


@pytest.mark.parametrize("cards,local_world,backend", [(2, "2", "nccl"), (1, "2", "gloo"), (8, None, "nccl")])
def test_backend_rule(clean_env, cards, local_world, backend):
    """NCCL when every local rank has a card of its own, else gloo; the rank's
    card becomes the current device."""
    clean_env.setattr(torch.cuda, "is_available", lambda: True)
    clean_env.setattr(torch.cuda, "device_count", lambda: cards)
    clean_env.setenv("LOCAL_RANK", "1")
    if local_world:
        clean_env.setenv("LOCAL_WORLD_SIZE", local_world)
    with mock.patch("torch.distributed.init_process_group") as init, \
            mock.patch("torch.cuda.set_device") as set_device:
        assert multihost.init_distributed("file:///x", 2, 1) is True
        assert init.call_args_list == [_call(2, 1, "file:///x", backend)]
        set_device.assert_called_once_with(1 % cards)


@pytest.mark.parametrize("asked,cards,local_rank,got", [
    ("cpu", 0, None, "cpu"), ("cpu", 2, "1", "cpu"), ("cuda", 2, "3", "cuda:1"), ("cuda:0", 2, "1", "cuda:0"),
    ("cuda", 0, None, None)])
def test_local_device(clean_env, asked, cards, local_rank, got):
    """A mesh's device: the CPU only when asked for, else the rank's card
    (LOCAL_RANK modulo the card count, or the card named); without a card
    the mesh is refused rather than put on the CPU."""
    clean_env.setattr(torch.cuda, "is_available", lambda: cards > 0)
    clean_env.setattr(torch.cuda, "device_count", lambda: cards)
    if local_rank is not None:
        clean_env.setenv("LOCAL_RANK", local_rank)
    if got is None:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            collectives.local_device(asked)
    else:
        assert collectives.local_device(asked) == torch.device(got)


def test_real_two_rank_init(job):
    for r, out in enumerate(job.outs):
        assert out["init"] == {"rank": r, "world": WORLD, "backend": "gloo", "mesh": {"data": WORLD},
                               "device": "cpu", "no_card": out["init"]["no_card"]}
        assert "no CUDA device" in out["init"]["no_card"]


# ------------------------------------------------------------------ mesh

def test_shard_rays_and_replicated(job):
    for r, out in enumerate(job.outs):
        got = out["shard_and_replicate"]
        np.testing.assert_array_equal(got["rays"], RAYS[r * 4:(r + 1) * 4])
        np.testing.assert_array_equal(got["rays_whole"], RAYS)
        np.testing.assert_array_equal(got["ragged"], RAGGED)       # 7 rays stay whole on every rank
        np.testing.assert_array_equal(got["ragged_whole"], RAGGED)
        for a, b in zip(got["replicated"], VALUES):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# ------------------------------------------------------------ the DP step

def test_dp_step_matches_the_jax_trainer_on_a_two_device_mesh(job):
    """The two-rank step against the JAX step on two devices, at the
    tolerances of `test_torch_port_joint_step.py` (`proj_err` is held there
    against the op-by-op reference; here against the port's single rank)."""
    for out in job.outs:
        got = out["dp_step"]
        assert set(got["metrics"]) == set(job.jax_metrics) | {"maskcache_fill"}     # the port's own metric
        assert got["metrics"]["maskcache_fill"] == job.single["maskcache_fill"]
        for k, ref in job.jax_metrics.items():
            ref = job.single[k] if k == "proj_err" else ref
            np.testing.assert_allclose(got["metrics"][k], ref, rtol=1e-4, atol=1e-6, err_msg=k)
        _assert_state_matches(job.jax_state, _loaded(job.kw, got["state"]), job.old_obj, 1)


def test_dp_step_matches_the_single_rank_step(job):
    """Against the port's own step on one rank: the same loss, and the same
    gradients through Adam's moments (each rank's ray gradient is the world
    size times its share before the mean; a missing or extra factor fails)."""
    _assert_bitwise(job.outs[0]["dp_step"]["state"], job.outs[1]["dp_step"]["state"])
    got = job.outs[0]["dp_step"]
    np.testing.assert_allclose(got["metrics"]["loss_total"], job.single["loss_total"], rtol=1e-5)
    one, two = _loaded(job.kw, job.single_state), _loaded(job.kw, got["state"])
    for n in ("obj", "scene", "pose"):
        a, b = (convert.adam_state_to_numpy(getattr(t, f"opt_{n}_state")) for t in (one, two))
        assert a["count"] == b["count"] == 1
        for moment in ("mu", "nu"):
            la, lb = tree_leaves(a[moment]), tree_leaves(b[moment])
            scale = max(np.abs(x).max() for x in la)
            for x, y in zip(la, lb):
                np.testing.assert_allclose(y, x, rtol=2e-4, atol=1e-6 * scale, err_msg=f"{n} {moment}")


def test_replicate_state_after_drift(job):
    fresh = ranks.trainer_state(ranks.tiny_joint_trainer(job.kw))
    for out in job.outs:
        _assert_bitwise(out["replicate_after_drift"], fresh)


def test_fit_across_a_view_activation(job):
    """`fit(4, superstep=2)` from step 2 with views activated every 4 steps:
    a window, the activation of view 3 (broadcast from rank 0), a window.
    Under gloo the windows run eagerly and the history says so; the ranks end
    bit for bit equal, and the losses and moments agree with the same fit on
    one rank."""
    a, b = (out["fit_across_event"] for out in job.outs)
    _assert_bitwise(a["state"], b["state"])
    assert a["state"]["n_active"] == job.fit_state["n_active"] == 3
    assert [h["step"] for h in a["hist"]] == [h["step"] for h in job.fit_hist] == [4, 6]
    assert all(h["graph"] is False for h in a["hist"]) and "graph" not in job.fit_hist[0]
    for h, ref in zip(a["hist"], job.fit_hist):
        np.testing.assert_allclose(h["loss_total"], ref["loss_total"], rtol=1e-4)
    one, two = _loaded(job.fit_kw, job.fit_state), _loaded(job.fit_kw, a["state"])
    np.testing.assert_array_equal(one.poses_pnp.numpy(), two.poses_pnp.numpy())
    for n in ("obj", "scene"):
        for moment in ("mu", "nu"):
            la, lb = (tree_leaves(convert.adam_state_to_numpy(getattr(t, f"opt_{n}_state"))[moment])
                      for t in (one, two))
            scale = max(np.abs(x).max() for x in la)
            for x, y in zip(la, lb):
                np.testing.assert_allclose(y, x, rtol=2e-3, atol=1e-5 * scale, err_msg=f"{n} {moment}")


@pytest.mark.parametrize("i", range(len(CHUNKS)), ids=[f"chunk{c}" for c in CHUNKS])
def test_render_full_image_on_the_mesh(job, i):
    """Each rank's meshed render of the carried state against the JAX
    trainer's `render_full_image` on its two-device mesh, at the tolerance
    of `test_torch_port_eval.py`; and against the port's own render without
    a mesh."""
    ref = job.jax_renders[CHUNKS[i]]
    for out in job.outs:
        got = out[f"render{CHUNKS[i]}"]
        assert set(got["mesh"]) == set(ref) == {"rgb", "depth", "opacity", "depth_var"}
        for k, v in ref.items():
            assert got["mesh"][k].shape == v.shape == (SCENE["H"], SCENE["W"], v.shape[-1])
            np.testing.assert_allclose(got["mesh"][k], v, rtol=0, atol=1e-5 * max(1.0, float(np.abs(v).max())),
                                       err_msg=k)
            np.testing.assert_allclose(got["mesh"][k], got["alone"][k], rtol=1e-5, atol=1e-6, err_msg=k)
