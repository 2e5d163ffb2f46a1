"""The port's superstep: `_next_boundary`, `steps_scan(k)` and `fit(superstep=K)`.

Held against the JAX package's `JointTrainer` where the reference decides
something (the boundary candidates), and against the port's own sequential
path elsewhere: on the CPU a superstep window is the same graph-safe step run
k times, so `fit(n, superstep=4)` must give the parameters and Adam state of
`fit(n)` bit for bit, across host events and log steps. The schedules the
step now evaluates as tensor math (NeuS sharpness, the deformation prior's
weight, the corres-weight halving, the TV weights, the three lrs and Adam's
bias corrections) are held against their host values at steps on both sides
of each breakpoint: float64 formulas where the step evaluates in float32
(rtol 2e-6, a few float32 ulps plus the rounding of the argument), and the
same formula in numpy float32 where the reference evaluates a float32 power
of a rounded base (rtol 1e-6). The `cuda` case holds k graph replays against
k eager steps on the card (up to the run-dependent order of the kernels'
atomic sums) and skips here. The file imports JAX only inside the tests that
compare with the reference, so that the `cuda` case also runs where JAX is
not installed.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from poseprobe_tpu_torch.config import config as tcfg
from poseprobe_tpu_torch.data.synthetic import make_synthetic_scene as t_make
from poseprobe_tpu_torch.losses import object as tobj_l, scene as tscene_l
from poseprobe_tpu_torch.models.object_sdf import ObjectConfig as TObjectConfig
from poseprobe_tpu_torch.models.scene_nerf import SceneConfig as TSceneConfig
from poseprobe_tpu_torch.ops import compositing as tcomp
from poseprobe_tpu_torch.train import optim as toptim
from poseprobe_tpu_torch.train.trainer import JointTrainer, build_trainer, tv_weights

torch.set_num_threads(1)

SCENE = dict(n_train=3, n_test=1, H=32, W=32, seed=0, n_matches=16)
# `tests/test_superstep.py`'s tiny configuration, with an event of every kind
# inside the first 200 steps: activation every 50, a grid rescale at 30,
# re-registration at 40, BA at 70, a mask-cache refresh every 25, the
# pre-crop ending at 5, fine sampling and depth consistency from 60, the
# pose window closing at 100, the object phase ending after 100
EVENTS = dict(camera=dict(incremental=True, incremental_step=50, reregister_at_ratio=0.2,
                          ba_at_ratios=(0.35,)),
              object_model=dict(N_iters=100, use_maskcache=True),
              object_train=dict(N_iters=100, N_rand=32, pg_scale=(30,), maskcache_update_every=25,
                                lr_pose=1e-3, lr_pose_end=1e-4),
              scene_model=dict(rand_rays=48, sample_intvs=16, sample_intvs_fine=16, max_iter=200,
                               fine_sampling=True, ratio_start_fine_sampling_at_x=0.3),
              scene_train=dict(max_iter=200, precrop_iters=5, ratio_end_joint_nerf_pose_refinement=0.5))


def _cfg(cfg_mod, object_config, scene_config, data, **over):
    m = float(data.xyz_max[0])
    parts = {k: dict(v) for k, v in EVENTS.items()}
    for k, v in over.items():
        parts[k].update(v)
    return cfg_mod.ExperimentConfig(
        data=cfg_mod.DataConfig(near=data.near, far=data.far),
        camera=cfg_mod.CameraConfig(**parts["camera"]),
        pnp=cfg_mod.PnPConfig(use_pnp=False),
        object_model=object_config(xyz_min=(-m,) * 3, xyz_max=(m,) * 3, num_voxels=12 ** 3,
                                   num_voxels_base=12 ** 3, **parts["object_model"]),
        object_train=cfg_mod.ObjectTrainConfig(**parts["object_train"]),
        scene_model=scene_config(**parts["scene_model"]),
        scene_train=cfg_mod.SceneTrainConfig(**parts["scene_train"]))


def _port(**over):
    data = t_make(**SCENE)
    return JointTrainer(_cfg(tcfg, TObjectConfig, TSceneConfig, data, **over), data, device="cpu")


# ---------------------------------------------------------------- boundaries


def test_next_boundary_gives_the_references_candidates():
    """At the steps on both sides of every event and flip: the same next
    boundary as the JAX trainer, with views still to activate and without."""
    from poseprobe_tpu.config import config as jcfg
    from poseprobe_tpu.data.synthetic import make_synthetic_scene as j_make
    from poseprobe_tpu.models.object_sdf import ObjectConfig as JObjectConfig
    from poseprobe_tpu.models.scene_nerf import SceneConfig as JSceneConfig
    from poseprobe_tpu.train.trainer import JointTrainer as JJointTrainer

    jdata = j_make(**SCENE)
    jt = JJointTrainer(_cfg(jcfg, JObjectConfig, JSceneConfig, jdata), jdata)
    tt = _port()
    assert tt.n_active == jt.state.n_active == 2
    events = (5, 25, 30, 40, 50, 60, 70, 75, 100, 101, 125, 150, 200)
    steps = sorted({s + d for s in events for d in (-1, 0, 1)} | {0})
    got = [tt._next_boundary(s) for s in steps]
    assert got == [jt._next_boundary(s) for s in steps]
    assert got[:3] == [5, 5, 25] and tt._next_boundary(59) == 60 and tt._next_boundary(100) == 101
    tt.n_active = jt.state.n_active = 3                    # every view active: no activation left
    assert [tt._next_boundary(s) for s in steps] == [jt._next_boundary(s) for s in steps]
    assert tt._next_boundary(201) > 10_000_000


@pytest.mark.parametrize("start,k,ok", [(58, 4, False), (58, 2, True), (24, 2, False), (26, 4, True)],
                         ids=["fine_flip", "up_to_the_flip", "refresh", "between_events"])
def test_steps_scan_refuses_to_cross_a_boundary(start, k, ok):
    tr = _port()
    tr.global_step = start
    if not ok:
        with pytest.raises(ValueError):
            tr.steps_scan(k)
        assert tr.global_step == start and int(tr._step_t) == start
        return
    hist = tr.steps_scan(k)
    assert tr.global_step == int(tr._step_t) == start + k
    assert all(v.shape == (k,) for v in hist.values()) and np.isfinite(hist["loss_total"].numpy()).all()


# ---------------------------------------------------------------- fit


def test_fit_superstep_is_bit_identical_to_single_steps(monkeypatch):
    """`fit(14, log_every=5, superstep=4)` against `fit(14, log_every=5)` from
    the same init: the same windows of steps around the mask-cache refresh
    at 6 and the log steps 5 and 10, and bit-identical params, Adam states,
    step counters and logged metrics."""
    over = dict(object_train=dict(maskcache_update_every=6, pg_scale=()),
                camera=dict(incremental_step=1000, reregister_at_ratio=None, ba_at_ratios=()))
    a, b = _port(**over), _port(**over)
    windows = []
    scan = type(b).steps_scan

    def record(self, k):
        windows.append((self.global_step, k))
        return scan(self, k)
    monkeypatch.setattr(type(b), "steps_scan", record)
    ha = a.fit(14, log_every=5)
    hb = b.fit(14, log_every=5, superstep=4)
    assert windows == [(0, 4), (6, 4)]
    assert ha == hb and [h["step"] for h in hb] == [5, 10]
    assert a.global_step == b.global_step == 14 and int(a._step_t) == int(b._step_t) == 14
    for x, y in zip(a.state_tensors(), b.state_tensors()):
        assert x.shape == y.shape and torch.equal(x, y)
    assert int(b.opt_obj_state["count"]) == int(b.opt_pose_state["count"]) == 14


def test_fit_superstep_crosses_activation_and_rescale_like_single_steps():
    """An activation at 12 and a grid rescale at 9 inside `fit(15,
    superstep=4)`: windows stop at both, and the state is the single steps'."""
    over = dict(camera=dict(incremental_step=12, reregister_at_ratio=None, ba_at_ratios=()),
                object_train=dict(pg_scale=(9,), maskcache_update_every=1000))
    a, b = _port(**over), _port(**over)
    a.fit(15)
    b.fit(15, superstep=4)
    assert a.n_active == b.n_active == 3 and a.obj_params["sdf_grid"].shape == b.obj_params["sdf_grid"].shape
    for x, y in zip(a.state_tensors(), b.state_tensors()):
        assert torch.equal(x, y)


# ---------------------------------------------------------------- schedules


def _f64_close(dev, host, rtol=2e-6):
    np.testing.assert_allclose(np.asarray(dev, np.float64), host, rtol=rtol, atol=0)


def test_s_val_schedule_on_a_step_tensor():
    om = TObjectConfig()
    for step in (0, 1, om.step_start, om.step_start + 1, om.N_iters - 1, om.N_iters, om.N_iters + 1):
        dev = tcomp.s_val_schedule(torch.tensor(step, dtype=torch.float32), om.s_ratio, om.s_start,
                                   om.step_start)
        assert dev.dtype == torch.float32
        _f64_close(dev, om.s_ratio / (step + om.s_ratio / om.s_start - om.step_start))


def test_dynamic_weight_on_a_step_tensor():
    for step in (0, 1, 99, 100, 101, 9999, 10000, 10001):
        dev = tobj_l.dynamic_weight(0.1, 1e-3, torch.tensor(step), 10000)
        assert dev.dtype == torch.float32
        _f64_close(dev, 0.1 * math.exp(math.log(1e-3 / 0.1) / 10000 * step))


def test_corres_weight_halving_on_a_step_tensor():
    """The halving every `corres_weight_reduct_at_x_iter` steps after the start,
    against the same loss without it divided by the host's power of two."""
    sc = tcfg.SceneTrainConfig(iter_start_decrease_corres_weight=10, corres_weight_reduct_at_x_iter=20)
    flat = dataclasses.replace(sc, gradually_decrease_corres_weight=False)
    rng = np.random.default_rng(3)
    K = torch.tensor([[[30.0, 0, 16], [0, 30.0, 16], [0, 0, 1]]] * 2)
    poses = torch.cat([torch.eye(3)[None].expand(2, 3, 3), torch.tensor([[[0.0], [0], [2]], [[0.1], [0], [2]]])], -1)
    args = (torch.tensor(2 + rng.random((2, 6)), dtype=torch.float32), None, poses, K,
            torch.tensor(rng.random((6, 2)) * 8 + 12, dtype=torch.float32),
            torch.tensor(rng.random((6, 2)) * 8 + 12, dtype=torch.float32), torch.ones(6),
            torch.tensor(0), torch.tensor(1))
    base = tscene_l.correspondence_loss_from_depths(*args, 0, flat)
    for step in (9, 10, 11, 29, 30, 31, 49, 50, 51):
        host = 2.0 ** math.floor((step - 10) / 20) if step >= 10 else 1.0
        dev = tscene_l.correspondence_loss_from_depths(*args, torch.tensor(step), sc)
        assert dev.item() == (base / host).item(), step


def test_tv_updates_on_a_step_tensor():
    ot = tcfg.ObjectTrainConfig()
    (ev, upd), = ot.tv_updates
    for step in (0, ev - 1, ev, ev + 1):
        sdf_tv, smooth_tv = tv_weights(ot, torch.tensor(step))
        host = dict(upd) if step >= ev else {"sdf_tv": ot.sdf_tv, "smooth_grad_tv": ot.smooth_grad_tv}
        assert sdf_tv.item() == np.float32(host["sdf_tv"]) and smooth_tv.item() == np.float32(host["smooth_grad_tv"])


def _f32(x):
    return np.float32(x)


def test_object_lrs_on_a_count_tensor():
    """Every module's lr at the counts on both sides of each staged drop."""
    ot = tcfg.ObjectTrainConfig()
    opt = toptim.ObjectOptimizer(ot)
    drops = [s for s, _ in ot.decay_step_module]
    for key in opt.base_lr:
        for count in sorted({0} | {d + e for d in drops for e in (-1, 0, 1)}):
            host = _f32(opt.base_lr[key]) * _f32(0.1) ** (_f32(count) / _f32(opt.decay_steps))
            for ev, factor in opt.events[key]:
                host = host * _f32(factor if count >= ev else 1.0)
            np.testing.assert_allclose(opt.lr(key, torch.tensor(count)).item(), host, rtol=1e-6)


def test_scene_lr_on_a_count_tensor():
    opt = toptim.SceneOptimizer(tcfg.SceneTrainConfig())
    for count in (0, 1, 17999, 18000, 59999, 60000):
        host = _f32(opt.base_lr) * _f32(opt.gamma) ** _f32(count)
        np.testing.assert_allclose(opt.lr(torch.tensor(count)).item(), host, rtol=1e-6)


@pytest.mark.parametrize("trans", [None, 300])
def test_pose_lrs_on_a_count_tensor(trans):
    """The pose lr, and with a translation window the frozen-past-the-window
    lrs, at the counts on both sides of each window's end."""
    opt = toptim.PoseOptimizer(tcfg.ObjectTrainConfig(lr_pose=1e-3, lr_pose_end=1e-4), 200, trans)
    for window in {opt.rot_window, opt.trans_window}:
        for count in (0, window - 1, window, window + 1):
            host = _f32(opt.lr_pose) * _f32(opt._gamma(window)) ** _f32(min(count, window))
            freeze = opt.split
            host = host * _f32(count < window) if freeze else host
            np.testing.assert_allclose(opt._lr_window(torch.tensor(count), window, freeze).item(), host,
                                       rtol=1e-6)


def test_adam_bias_corrections_on_a_count_tensor():
    adam = toptim._Adam(0.9, 0.999)
    for count in (1, 2, 10, 1000, 60000):
        c1, c2 = adam.bias_corrections(torch.tensor(count))
        np.testing.assert_allclose(c1.item(), 1 - _f32(0.9) ** _f32(count), rtol=1e-6)
        np.testing.assert_allclose(c2.item(), 1 - _f32(0.999) ** _f32(count), rtol=1e-6)


# ---------------------------------------------------------------- the card


@pytest.mark.cuda
def test_graph_replays_match_eager_steps_on_the_card():
    """k = 4 steps of the bench-shaped joint trainer (small) from one state:
    eagerly, then as a superstep window (an eager first step under the
    sync-debug error mode, capture, three replays), then as four replays of
    the captured step. Per-step losses within 1e-3 and every parameter tensor
    within 2e-2 in the L2 norm relative to its own: the trilinear scatter and
    the trunk's dW/db add with atomics in a run-dependent order, so a
    near-cancelling gradient element can change sign and take an Adam step
    the other way (a sparse difference, up to 2 lr per element). Step
    counters, Adam counts and the kernels' launch counts agree exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from poseprobe_tpu_torch.core.tree import tree_leaves
    from poseprobe_tpu_torch.train import graphs
    tr = build_trainer(small=True, device="cuda")
    tr.global_step = 1
    tr.step()
    start = ([t.clone() for t in tr.state_tensors()], tr.generator.get_state(), tr.global_step)

    def run(window: bool):
        for t, c in zip(tr.state_tensors(), start[0]):
            t.copy_(c)
        tr.generator.set_state(start[1])
        tr.global_step = start[2]
        before = graphs._counts()
        if window:
            losses = tr.steps_scan(4)["loss_total"]
        else:
            losses = torch.stack([tr.step()["loss_total"] for _ in range(4)])
        torch.cuda.synchronize()
        launched = [b - a for a, b in zip(before, graphs._counts())]
        params = [t.clone() for n in tr.GROUPS for t in tree_leaves(getattr(tr, f"{n}_params"))]
        counters = [int(tr._step_t)] + [int(getattr(tr, f"opt_{n}_state")["count"]) for n in tr.GROUPS
                                        if getattr(tr, f"opt_{n}_state") is not None]
        return losses.cpu(), params, counters, launched

    eager = run(False)
    for name, out in (("capture", run(True)), ("replays", run(True))):
        assert tr._graphs.graph is not None, name
        np.testing.assert_allclose(out[0].numpy(), eager[0].numpy(), rtol=1e-3, err_msg=name)
        assert out[2] == eager[2] and out[3] == eager[3] and sum(out[3]) > 0, (name, out[2:], eager[2:])
        for a, b in zip(out[1], eager[1]):
            assert (a - b).norm().item() <= 2e-2 * max(b.norm().item(), 1e-30), name
    assert tr.global_step == start[2] + 4


@pytest.mark.cuda
def test_fit_in_superstep_windows_from_a_fresh_trainer_on_the_card():
    """`fit(superstep=K)` as the first thing a process trains: the first
    window's eager step runs under the sync-debug error mode and makes the
    step's device constants there (`core/graphsafe.const`: an asynchronous
    copy from pinned memory, no synchronisation)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from poseprobe_tpu_torch.core import graphsafe
    graphsafe._make.cache_clear()
    tr = build_trainer(small=True, device="cuda")
    tr.global_step = 1
    hist = tr.fit(8, log_every=4, superstep=4)
    assert tr._graphs.graph is not None and [h["step"] for h in hist] == [4, 8]
    assert all(math.isfinite(v) for h in hist for v in h.values())
