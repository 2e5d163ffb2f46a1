"""The port's host pose events and `JointTrainer.fit()` held against the JAX package's.

Modules, each against its JAX counterpart on the same numpy inputs:

* `core/align.py` (host float64): the same numpy arithmetic, 1e-12.
* `pose_init/pnp.py`: the deterministic parts (`_pnp_dlt`, `_median_reproj_err`,
  `reproj_for_pose`, the fixed-seed `_pnp_ransac_numpy`, `_holdout_reproj` and
  `solve_pnp` over it) at 1e-9; the OpenCV path (`cv2.solvePnPRansac` draws
  its own samples) to 1e-3 in the pose on clean analytic matches; the anchor
  lifting of `pnp_from_matches` / `pnp_from_scene_depth` /
  `pnp_from_matches_scalefixed` / `initialize_poses_pnp` through the port's
  surface query and scene render, poses within 2e-3 (the anchors agree to
  float32 rounding; the DLT amplifies it).
* `pose_init/ba.py`, `pose_init/relpose.py` with OpenCV: 1e-7; without it,
  every entry point declines.
* `eval/evaluator.py`: the warmup (`test_time_pose_optim`, incl. `rot_only` and
  `center_anchor`) and the fixed-ray score with the JAX draws injected, and
  `render_full`: 1e-4 in the pose after 5 Adam steps, 1e-5 relative in the score.

The slice as a whole: both packages' `JointTrainer` on the same small
synthetic scene (32x32 views, 12^3 grids, 48 object rays, 4x32 trunk) with
`use_pnp=True`, the fixed-seed numpy PnP, `use_pallas_composite=True` and the
mask cache; `fit()` across the activation of view 2 with warmup, photometric
gate, match guard and match refinement on. Compared: `poses_pnp` at init, the
number of active views, the activated pose, and the step metrics after the
event, with the tolerances stated at the asserts. The scenarios of
`tests/test_protocols.py` and `tests/test_probe_health.py` are repeated for the
port's trainer, and every branch of `maybe_activate_view` (gates, rescue,
anchor modes, protocols) is driven once on it.
"""
import dataclasses
import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseprobe_tpu.config import config as jcfg
from poseprobe_tpu.core import align as jalign
from poseprobe_tpu.data.synthetic import make_synthetic_scene as j_make
from poseprobe_tpu.eval import evaluator as jeval
from poseprobe_tpu.models.object_sdf import ObjectConfig as JObjectConfig
from poseprobe_tpu.models.scene_nerf import SceneConfig as JSceneConfig
from poseprobe_tpu.pose_init import ba as jba, pnp as jpnp, relpose as jrel
from poseprobe_tpu.train.trainer import JointTrainer as JJointTrainer
from poseprobe_tpu_torch import convert
from poseprobe_tpu_torch.config import config as tcfg
from poseprobe_tpu_torch.core import align as talign
from poseprobe_tpu_torch.data.synthetic import make_synthetic_scene as t_make
from poseprobe_tpu_torch.eval import evaluator as teval
from poseprobe_tpu_torch.models.object_sdf import ObjectConfig as TObjectConfig
from poseprobe_tpu_torch.models.scene_nerf import SceneConfig as TSceneConfig
from poseprobe_tpu_torch.pose_init import ba as tba, pnp as tpnp, relpose as trel
from poseprobe_tpu_torch.train import trainer as ttrainer
from poseprobe_tpu_torch.train.trainer import JointTrainer as TJointTrainer, ProbeHealthError
from test_torch_port_joint_step import _draws_from_jax

torch.set_num_threads(1)

SM = dict(layers_feat=(32,) * 4, layers_rgb=(16, 3), skip=(2,), L_3D=4, L_view=2,
          sample_intvs=16, sample_intvs_fine=16, rand_rays=64, max_iter=100,
          fine_sampling=True, ratio_start_fine_sampling_at_x=0.3, barf_c2f=(0.1, 0.5),
          matmul_dtype="float32")
ST = dict(max_iter=100, corres_weight_reduct_at_x_iter=20)
# small learning rates for the grids: the comparison runs over several Adam
# steps, and Adam moves an element whose gradient is float32 noise by +-lr
OT = dict(N_iters=50, N_rand=48, lr_pose=1e-3, lr_pose_end=1e-4, lrate_sdf=1e-3, lrate_k0=1e-3,
          maskcache_update_every=4)
SCENE = dict(n_train=3, n_test=1, H=32, W=32, seed=0, n_matches=32)
CAM = dict(incremental=True, incremental_step=3, activation_pose_warmup=4,
           activation_warmup_photo_ratio=1.5, ba_at_ratios=(0.05,))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _state_np(jt):
    """The JAX trainer's `TrainState` with numpy leaves, for `convert.load_trainer_state`."""
    import types
    st = jt.state
    return types.SimpleNamespace(
        step=st.step, n_active=st.n_active, poses_pnp=np.asarray(st.poses_pnp),
        **{k: _np(getattr(st, k)) for k in ("obj_params", "scene_params", "pose_params", "opt_obj",
                                            "opt_scene", "opt_pose")})


def _configs(data, cam=None, pnp=None, oc_over=None, ot=None, sm=None, st=None):
    m = float(data.xyz_max[0])
    oc = dict(xyz_min=(-m,) * 3, xyz_max=(m,) * 3, num_voxels=12 ** 3, num_voxels_base=12 ** 3,
              N_iters=50, world_bound_scale=1.25, use_maskcache=True, barf_c2f=(0.05, 0.4),
              use_pallas_composite=True)
    oc.update(oc_over or {})
    out = []
    for C, OC, SC in ((jcfg, JObjectConfig, JSceneConfig), (tcfg, TObjectConfig, TSceneConfig)):
        out.append(C.ExperimentConfig(
            data=C.DataConfig(near=data.near, far=data.far), camera=C.CameraConfig(**(cam or CAM)),
            pnp=C.PnPConfig(**(pnp or dict(use_pnp=True))), object_model=OC(**oc),
            object_train=C.ObjectTrainConfig(**(ot or OT)), scene_model=SC(**(sm or SM)),
            scene_train=C.SceneTrainConfig(**(st or ST))))
    return out


@pytest.fixture(scope="module")
def numpy_pnp():
    """Both packages on the fixed-seed numpy PnP (the path of a machine without OpenCV)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jpnp, "_HAS_CV2", False)
    mp.setattr(tpnp, "_HAS_CV2", False)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def pair(numpy_pnp):
    """(JAX trainer, port trainer) built on the same scene with `use_pnp=True`."""
    jdata, tdata = j_make(**SCENE), t_make(**SCENE)
    jc, tc = _configs(jdata)
    return JJointTrainer(jc, jdata, seed=0), TJointTrainer(tc, tdata, seed=0, device="cpu")


def _poses(n, seed, spread=0.3):
    """Random w2c poses [n, 3, 4] looking roughly at the origin from ~2 units."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        w = rng.normal(size=3) * spread
        out.append(np.concatenate([talign.se3_to_SE3_host(np.concatenate([w, np.zeros(3)])[None])[0][:, :3],
                                   (np.array([0.0, 0.0, 2.0]) + rng.normal(size=3) * 0.2)[:, None]], axis=1))
    return np.stack(out)


# ---------------------------------------------------------------- core/align


def test_align_host_math_matches():
    rng = np.random.default_rng(0)
    wu = rng.normal(size=(5, 6)) * 0.3
    wu[0] = 0.0
    wu[1, :3] *= 1e-9                         # the small-angle series switch
    np.testing.assert_allclose(talign.se3_to_SE3_host(wu), jalign.se3_to_SE3_host(wu), rtol=0, atol=1e-12)
    a, b = _poses(5, 1), _poses(5, 2)
    np.testing.assert_allclose(talign.compose_pair_host(a, b), jalign.compose_pair_host(a, b), atol=1e-12)
    for fix_first in (True, False):
        np.testing.assert_allclose(talign.current_pose_pnp_host(wu, a, fix_first=fix_first),
                                   jalign.current_pose_pnp_host(wu, a, fix_first=fix_first), atol=1e-12)
    X0, X1 = rng.normal(size=(7, 3)), rng.normal(size=(7, 3))
    tp, jp = talign.procrustes_analysis(X0, X1), jalign.procrustes_analysis(X0, X1)
    assert set(tp) == set(jp) == {"t0", "t1", "s0", "s1", "R"}
    for k in tp:
        np.testing.assert_allclose(tp[k], jp[k], atol=1e-12, err_msg=k)
    for x, y in zip(talign.umeyama_alignment(X0.T, X1.T), jalign.umeyama_alignment(X0.T, X1.T)):
        np.testing.assert_allclose(x, y, atol=1e-12)


@pytest.mark.parametrize("n", [3, 6, 12])
def test_align_trajectories_matches(n):
    """Prealignment (pairwise for n < 10, sim3 above), the pose errors, the
    backtrack of test poses and the point map, on a trajectory that is the GT
    one under a similarity plus noise."""
    gt = _poses(n, 3)
    rng = np.random.default_rng(n)
    c2w = talign._invert(gt)
    R0 = talign.se3_to_SE3_host(np.array([[0.3, -0.2, 0.5, 0, 0, 0]]))[0][:, :3]
    c2w_est = np.concatenate([R0 @ c2w[:, :, :3], (1.7 * c2w[:, :, 3] @ R0.T + np.array([0.3, -1.0, 0.2])
                                                   + rng.normal(size=(n, 3)) * 0.01)[..., None]], axis=2)
    # both packages get the same float32 poses (what a trainer holds): the pairwise
    # anchor search is an argmin that input rounding can flip
    est, gt = talign._invert(c2w_est).astype(np.float32), gt.astype(np.float32)
    for tf, jf in ((talign.prealign_w2c_small_camera_systems, jalign.prealign_w2c_small_camera_systems),
                   (talign.prealign_w2c_large_camera_systems, jalign.prealign_w2c_large_camera_systems),
                   (teval.align_train_poses, jeval.align_train_poses)):
        (ta, ts), (ja, js) = tf(est, gt), jf(est, gt)
        np.testing.assert_allclose(np.asarray(ta), np.asarray(ja), atol=1e-6)
        te, je = talign.evaluate_camera_alignment(ta, gt), jalign.evaluate_camera_alignment(ja, gt)
        np.testing.assert_allclose(te["R"], je["R"], atol=1e-6)
        np.testing.assert_allclose(te["t"], je["t"], atol=1e-6)
        assert float(np.max(te["R"])) < 2.0      # the alignment really undoes the similarity
        back_t = talign.backtrack_from_aligning_the_trajectory(gt[:2], ts)
        back_j = np.asarray(jalign.backtrack_from_aligning_the_trajectory(gt[:2], js))
        assert back_t.dtype == np.float32 and back_t.shape == (2, 3, 4)
        np.testing.assert_allclose(back_t, back_j, atol=1e-6)
        pts = rng.normal(size=(9, 3))
        np.testing.assert_allclose(talign.apply_sim3_points(pts, ts), jalign.apply_sim3_points(pts, js), atol=1e-9)


# ---------------------------------------------------------------- pose_init/pnp


def _pnp_problem(n=60, seed=0, noise_px=0.0, planar=False):
    """World points in front of a camera, their pixels under a known pose, and a nearby previous pose."""
    rng = np.random.default_rng(seed)
    K = np.array([[40.0, 0, 16.0], [0, 40.0, 16.0], [0, 0, 1]])
    pose = _poses(1, seed + 10)[0]
    pts = rng.uniform(-0.35, 0.35, (n, 3))
    if planar:
        pts[:, 2] = 0.35
    pc = pts @ pose[:, :3].T + pose[:, 3]
    px = (pc[:, :2] / pc[:, 2:]) @ K[:2, :2].T + K[:2, 2] + rng.normal(size=(n, 2)) * noise_px
    prev = talign.compose_pair_host(talign.se3_to_SE3_host(rng.normal(size=(1, 6)) * 0.05)[0], pose)
    return pts, px, K, pose, prev.astype(np.float32)


@pytest.mark.parametrize("noise_px,planar", [(0.0, False), (0.5, False), (0.3, True)])
def test_pnp_deterministic_parts_match(noise_px, planar, numpy_pnp):
    pts, px, K, pose, prev = _pnp_problem(noise_px=noise_px, planar=planar)
    td, jd = tpnp._pnp_dlt(pts[:8], px[:8], K), jpnp._pnp_dlt(pts[:8], px[:8], K)
    assert (td is None) == (jd is None)
    if td is not None:
        np.testing.assert_allclose(td, jd, atol=1e-9)
    tr_, jr_ = tpnp._pnp_ransac_numpy(pts, px, K, prev), jpnp._pnp_ransac_numpy(pts, px, K, prev)
    np.testing.assert_allclose(tr_, jr_, atol=1e-9)
    assert tpnp._median_reproj_err(tr_, pts, px, K) == jpnp._median_reproj_err(jr_, pts, px, K)
    assert tpnp._holdout_reproj(pts, px, K, prev) == pytest.approx(jpnp._holdout_reproj(pts, px, K, prev), abs=1e-9)
    assert tpnp._holdout_reproj(pts[:10], px[:10], K, prev) == float("inf")
    tp, jp = tpnp.solve_pnp(pts, px, K, prev), jpnp.solve_pnp(pts, px, K, prev)
    np.testing.assert_allclose(tp, jp, atol=1e-9)
    tq, jq = tpnp.LAST_QUALITY, jpnp.LAST_QUALITY
    assert set(tq) == set(jq) and tq["n_pts"] == jq["n_pts"] == len(pts) and tq["fallback"] == jq["fallback"]
    for k in ("med_reproj_px", "holdout_reproj_px"):
        assert tq[k] == pytest.approx(jq[k], abs=1e-9)
    assert tpnp.reproj_for_pose(tq, prev) == pytest.approx(jpnp.reproj_for_pose(jq, prev), abs=1e-9)
    assert tpnp.reproj_for_pose(None, prev) == float("inf")
    if noise_px == 0.0:
        np.testing.assert_allclose(tp, pose, atol=1e-4)     # and it is the pose that made the pixels
    assert tpnp.pnp_path() == "numpy"


def test_pnp_opencv_path_recovers_the_pose(monkeypatch):
    """With OpenCV both packages call `cv2.solvePnPRansac` + LM: on clean
    matches both land on the true pose (1e-3), on each other (1e-3), with the
    same quality record."""
    pytest.importorskip("cv2")
    monkeypatch.setattr(jpnp, "_HAS_CV2", True)      # whatever the module-wide numpy fixture set
    monkeypatch.setattr(tpnp, "_HAS_CV2", True)
    assert tpnp.pnp_path() == "cv2"
    pts, px, K, pose, prev = _pnp_problem(n=80, seed=4)
    tp, jp = tpnp.solve_pnp(pts, px, K, prev), jpnp.solve_pnp(pts, px, K, prev)
    np.testing.assert_allclose(tp, pose, atol=1e-3)
    np.testing.assert_allclose(tp, jp, atol=1e-3)
    assert not tpnp.LAST_QUALITY["fallback"] and tpnp.LAST_QUALITY["med_reproj_px"] < 0.1
    assert tpnp.LAST_QUALITY["holdout_reproj_px"] == pytest.approx(jpnp.LAST_QUALITY["holdout_reproj_px"], abs=0.05)


def test_initial_pnp_chain_matches(pair):
    """`initialize_poses_pnp` at trainer construction: surface anchors from the
    cube SDF under the previous view's match pixels, fixed-seed numpy PnP.
    Both chains start at the GT pose of view 0; 2e-3 on the solved poses."""
    jt, tt = pair
    jp, tp = np.asarray(jt.state.poses_pnp), tt.poses_pnp.numpy()
    np.testing.assert_array_equal(tp[0], np.asarray(jt.poses_gt)[0])
    np.testing.assert_allclose(tp, jp, rtol=0, atol=2e-3)
    # a real solve in GT's neighbourhood (the 6-point DLT on a cube-initialised
    # probe seen at 32 px is a coarse seed: rotations within ~15 degrees)
    assert np.abs(tp[1:] - tt.poses_gt.numpy()[1:]).max() < 0.5
    assert np.abs(tp[1] - tp[0]).max() > 1e-2                        # and not the fallback to the previous pose
    assert tt.fix_first_pose and jt._fix_first_pose
    assert tt.n_active == jt.state.n_active == 2
    assert tt._k_phase == jt._k_phase and tt._mask_k == jt._mask_k


def test_use_identical_seeds_every_view_with_the_first_pose():
    tdata = t_make(**SCENE)
    _, tc = _configs(tdata, pnp=dict(use_pnp=False, use_identical=True))
    tt = TJointTrainer(tc, tdata, seed=0, device="cpu")
    for i in range(3):
        np.testing.assert_array_equal(tt.poses_pnp[i].numpy(), tt.poses_gt[0].numpy())
    assert tt.fix_first_pose


@pytest.mark.parametrize("which", ["object", "scene", "object_scaled"])
def test_activation_anchor_modes_match(pair, which, numpy_pnp):
    """The three anchor sources of activation-time PnP, on the trainers' init state."""
    jt, tt = pair
    jst = jt.state
    tobj = convert.object_params_from_jax(_np(jst.obj_params), "cpu")
    tscene = convert.scene_params_from_jax(_np(jst.scene_params), "cpu")
    K, prev = np.asarray(jt.Ks[2]), np.asarray(jt.poses_gt[1])
    opack, spack = np.asarray(jt.obj_matches[2]), np.asarray(jt.scene_matches[2])
    near, far = jt.data.near, jt.data.far
    if which == "object":
        args = (opack, K, prev)
        kw = dict(inverse_y=jt.data.inverse_y, near=near, far=far, extra_packs=[spack])
        jp = jpnp.pnp_from_matches(jst.obj_params, jt.cfg.object_model, *args, **kw)
        tp = tpnp.pnp_from_matches(tobj, tt.cfg.object_model, *args, **kw)
    elif which == "scene":
        kw = dict(depth_range=(near, far), progress=0.3, use_fine=False)
        jp = jpnp.pnp_from_scene_depth(jst.scene_params, jt.cfg.scene_model, spack, K, prev, **kw)
        tp = tpnp.pnp_from_scene_depth(tscene, tt.cfg.scene_model, spack, K, prev, **kw)
    else:
        kw = dict(inverse_y=jt.data.inverse_y, near=near, far=far, progress=0.3, use_fine=False)
        jp = jpnp.pnp_from_matches_scalefixed(jst.obj_params, jt.cfg.object_model, opack, K, prev,
                                              scene_params=jst.scene_params, scene_cfg=jt.cfg.scene_model, **kw)
        tp = tpnp.pnp_from_matches_scalefixed(tobj, tt.cfg.object_model, opack, K, prev,
                                              scene_params=tscene, scene_cfg=tt.cfg.scene_model, **kw)
    assert tp.shape == (3, 4)
    np.testing.assert_allclose(tp, np.asarray(jp), rtol=0, atol=2e-3)
    tq, jq = tpnp.LAST_QUALITY, jpnp.LAST_QUALITY
    assert (tq is None) == (jq is None)
    if tq is not None:
        assert tq["n_pts"] == jq["n_pts"]
        np.testing.assert_allclose(tq["world_pts"], jq["world_pts"], atol=1e-4)
    # too few valid matches: the previous pose comes back untouched
    few = opack.copy()
    few[4:, 4] = 0.0
    back = tpnp.pnp_from_matches(tobj, tt.cfg.object_model, few, K, prev, inverse_y=jt.data.inverse_y,
                                 near=near, far=far)
    np.testing.assert_array_equal(back, prev)


# ---------------------------------------------------------------- pose_init/ba, relpose


def _ba_problem(noise=0.02, seed=0):
    data = t_make(n_train=4, n_test=1, H=64, W=64, seed=0, n_matches=48)
    gt = np.asarray(data.poses_gt_w2c[data.i_train], np.float64)
    Ks = np.asarray(data.Ks[data.i_train], np.float64)
    packs, pairs = [], []
    for i in range(1, 4):
        packs += [np.asarray(data.scene_matches[i]), np.asarray(data.obj_matches[i])]
        pairs += [(int(data.pair_j[i]), i)] * 2
    for pack, ab in zip(data.ba_matches, data.ba_pairs):
        packs.append(np.asarray(pack))
        pairs.append((int(ab[0]), int(ab[1])))
    rng = np.random.default_rng(seed)
    noisy = gt.copy()
    for i in range(1, 4):
        noisy[i] = talign.compose_pair_host(gt[i], talign.se3_to_SE3_host(rng.normal(size=(1, 6)) * noise)[0])
    return gt, noisy, Ks, packs, pairs


def test_ba_and_match_refine_match():
    gt, noisy, Ks, packs, pairs = _ba_problem()
    tobs, jobs = tba.observations_from_packs(packs, pairs, 4), jba.observations_from_packs(packs, pairs, 4)
    assert len(tobs) == len(jobs) == len(packs)
    for a, b in zip(tobs, jobs):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert len(tba.observations_from_packs(packs, pairs, 3)) < len(tobs)     # pairs of inactive views drop out
    for view in (1, 3):
        assert tba.view_match_med_px(noisy, Ks, tobs, view) == pytest.approx(
            jba.view_match_med_px(noisy, Ks, jobs, view), abs=1e-7)
    assert tba.view_match_med_px(gt, Ks, tobs, 3) < 0.05 < tba.view_match_med_px(noisy, Ks, tobs, 3)
    starts = [("noisy", noisy[3]), ("prev", noisy[2])]
    (tr_, ti), (jr_, ji) = (m.refine_view_matches(noisy, Ks, o, 3, starts=starts)
                            for m, o in ((tba, tobs), (jba, jobs)))
    assert ti["applied"] and ji["applied"] and ti["start"] == ji["start"]
    np.testing.assert_allclose(tr_, jr_, atol=1e-7)
    assert ti["med_px"] == pytest.approx(ji["med_px"], abs=1e-7)
    assert tba.refine_view_matches(noisy, Ks, [], 3)[1]["applied"] is False
    (tp, ti), (jp, ji) = (m.polish_poses_matches(noisy, Ks, o, fix_first=True)
                          for m, o in ((tba, tobs), (jba, jobs)))
    assert ti["applied"] and ji["applied"] and ti["rounds"] == ji["rounds"]
    np.testing.assert_allclose(tp, jp, atol=1e-7)
    assert ti["med_reproj_px"] == pytest.approx(ji["med_reproj_px"], abs=1e-7)
    np.testing.assert_array_equal(tp[0], noisy[0])                            # the gauge anchor stays
    aligned, _ = talign.prealign_w2c_small_camera_systems(tp, gt)
    err = talign.evaluate_camera_alignment(aligned, gt)
    aligned0, _ = talign.prealign_w2c_small_camera_systems(noisy, gt)
    err0 = talign.evaluate_camera_alignment(aligned0, gt)
    assert err["R"].max() < 0.5 * err0["R"].max()                             # and the polish polishes


def test_relpose_matches():
    gt, noisy, Ks, packs, pairs = _ba_problem()
    use = [packs[0], packs[1]]                        # the scene and object packs of pair (0, 1)
    (tR, tt_, tn), (jR, jt_, jn) = trel.essential_relative_pose(use, Ks[1]), jrel.essential_relative_pose(use, Ks[1])
    assert tn == jn and (tR is None) == (jR is None)
    if tR is not None:
        np.testing.assert_allclose(tR, jR, atol=1e-7)
        np.testing.assert_allclose(tt_, jt_, atol=1e-7)
    pts, px, K, pose, prev = _pnp_problem(n=60, seed=2)
    for gate in (0.01, 50.0):
        (tp, tinfo), (jp, jinfo) = (m.apply_essential_guard(pose.astype(np.float32), prev, use, K, pts, px, gate_deg=gate)
                                    for m in (trel, jrel))
        np.testing.assert_allclose(tp, jp, atol=1e-6)
        assert tinfo.keys() == jinfo.keys() and tinfo["applied"] == jinfo["applied"]
    assert trel.rotation_angle_deg(gt[0][:, :3], gt[1][:, :3]) == jrel.rotation_angle_deg(gt[0][:, :3], gt[1][:, :3])


def test_ba_and_relpose_decline_without_opencv(monkeypatch):
    """A machine without OpenCV: nothing is triangulated, every entry point
    says "not applied" and returns the poses it was given."""
    gt, noisy, Ks, packs, pairs = _ba_problem()
    obs = tba.observations_from_packs(packs, pairs, 4)
    monkeypatch.setattr(tba, "_HAS_CV2", False)
    monkeypatch.setattr(trel, "_HAS_CV2", False)
    assert tba.view_match_med_px(noisy, Ks, obs, 3) == float("inf")
    refined, info = tba.refine_view_matches(noisy, Ks, obs, 3)
    assert info["applied"] is False
    np.testing.assert_allclose(refined, noisy[3], rtol=0, atol=1e-7)     # given back as float32
    polished, info = tba.polish_poses_matches(noisy, Ks, obs)
    assert info["applied"] is False
    np.testing.assert_allclose(polished, noisy, rtol=0, atol=1e-7)
    assert trel.essential_relative_pose(packs[:2], Ks[1]) == (None, None, 0)


# ---------------------------------------------------------------- eval/evaluator


def _jax_warmup_draws(seed, n_iters, rand_rays, n_pix):
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n_iters):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(sub, (rand_rays,), 0, n_pix)))
    return np.stack(out)


def _jax_score_draws(n_pix, rand_rays=2048, seed=17):
    return np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n_pix, (min(rand_rays, n_pix),), replace=False))


@pytest.fixture(scope="module")
def scene_state(pair):
    jt, _ = pair
    return (jt.state.scene_params, convert.scene_params_from_jax(_np(jt.state.scene_params), "cpu"),
            jt.cfg.scene_model, TSceneConfig(**SM), jt)


@pytest.mark.parametrize("kw", [dict(), dict(rot_only=True), dict(center_anchor=10.0), dict(use_fine=True)],
                         ids=["se3", "rot_only", "center_anchor", "fine"])
def test_warmup_matches_with_injected_draws(scene_state, kw):
    jscene, tscene, jsm, tsm, jt = scene_state
    K, image = np.asarray(jt.Ks[2]), np.asarray(jt.images[2])
    pose0 = np.asarray(jt.poses_gt[1], np.float32)
    common = dict(n_iters=5, lr=3e-3, rand_rays=128, seed=3, progress=0.4, **kw)
    jp = np.asarray(jeval.test_time_pose_optim(jscene, jsm, jnp.asarray(pose0), jnp.asarray(K),
                                               jnp.asarray(image), (jt.data.near, jt.data.far), **common))
    idx = _jax_warmup_draws(3, 5, 128, 32 * 32)
    tp = teval.test_time_pose_optim(tscene, tsm, pose0, K, image, (jt.data.near, jt.data.far),
                                    ray_idx=idx, **common).numpy()
    assert np.abs(jp - pose0).max() > 5e-3          # five Adam steps of 3e-3 moved it
    # Adam normalises the gradient: after 5 steps the poses agree to ~1e-2 of a step
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-4)
    if kw.get("rot_only"):
        center = lambda p: -p[:, :3].T @ p[:, 3]  # noqa: E731
        np.testing.assert_allclose(center(tp), center(pose0), atol=1e-6)
    # without injected draws: reproducible from the seed, another pose than with the JAX draws
    own = dict(common, n_iters=2)
    a = teval.test_time_pose_optim(tscene, tsm, pose0, K, image, (jt.data.near, jt.data.far), **own)
    b = teval.test_time_pose_optim(tscene, tsm, pose0, K, image, (jt.data.near, jt.data.far), **own)
    assert torch.equal(a, b)


@pytest.mark.parametrize("use_fine", [False, True])
def test_photometric_score_and_render_full_match(scene_state, use_fine):
    jscene, tscene, jsm, tsm, jt = scene_state
    K, image = np.asarray(jt.Ks[1]), np.asarray(jt.images[1])
    rng_ = (jt.data.near, jt.data.far)
    idx = _jax_score_draws(32 * 32)
    assert len(np.unique(idx)) == len(idx) == 1024
    for pose in (np.asarray(jt.poses_gt[1]), np.asarray(jt.poses_gt[2])):
        js = jeval.photometric_pose_score(jscene, jsm, pose, jnp.asarray(K), jnp.asarray(image), rng_,
                                          progress=0.4, use_fine=use_fine)
        ts = teval.photometric_pose_score(tscene, tsm, pose, K, image, rng_, progress=0.4,
                                          use_fine=use_fine, ray_idx=idx)
        assert ts == pytest.approx(js, rel=1e-5)
        # the port's own subset: all 1024 pixels of this image, in another order
        assert teval.photometric_pose_score(tscene, tsm, pose, K, image, rng_, progress=0.4,
                                            use_fine=use_fine) == pytest.approx(js, rel=1e-4)
    pose = np.asarray(jt.poses_gt[0])
    jout = jeval.render_full(jscene, jsm, jnp.asarray(pose), jnp.asarray(K), 32, 32, rng_, chunk=300,
                             use_fine=use_fine, progress=0.4)
    tout = teval.render_full(tscene, tsm, pose, K, 32, 32, rng_, chunk=300, use_fine=use_fine, progress=0.4)
    assert set(tout) == set(jout)
    for k in jout:
        assert tuple(tout[k].shape) == tuple(jout[k].shape) and tout[k].shape[:2] == (32, 32)
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), rtol=1e-4, atol=1e-5, err_msg=k)


# ---------------------------------------------------------------- the slice: fit() across an activation


def test_fit_across_an_activation_matches(pair, monkeypatch, numpy_pnp):
    """Both trainers run `fit(5)` from the same state: steps 0-2 with two
    views, the activation of view 2 before step 3 (numpy PnP against the probe,
    photometric gate, guarded warmup, match guard, match refinement, chord-K
    re-bound), the mask-cache refresh before step 4, the BA polish before
    step 5 is outside. The port's steps take the JAX steps' draws, its warmup
    and scores the JAX events' draws."""
    jt, tt = pair
    convert.load_trainer_state(tt, _state_np(jt), mask_arr=np.asarray(jt.mask_arr), mask_k=jt._mask_k,
                               k_phase=jt._k_phase)
    assert tt.global_step == 0 and tt.n_active == 2

    # the loop keys `jt.fit` will split off, one per step
    rngs, key = [], jt._loop_key
    for _ in range(5):
        key, sub = jax.random.split(key)
        rngs.append(sub)
    monkeypatch.setattr(tt, "sample_draws", lambda flags: _draws_from_jax(jt, rngs[tt.global_step], flags))
    n_pix = tt.H * tt.W
    warm, score = teval.test_time_pose_optim, teval.photometric_pose_score
    monkeypatch.setattr(teval, "test_time_pose_optim", lambda *a, **k: warm(
        *a, ray_idx=_jax_warmup_draws(k.get("seed", 0), k["n_iters"], k["rand_rays"], n_pix), **k))
    monkeypatch.setattr(teval, "photometric_pose_score", lambda *a, **k: score(
        *a, ray_idx=_jax_score_draws(n_pix), **k))

    jbuf, tbuf = io.StringIO(), io.StringIO()
    with redirect_stdout(jbuf):
        jhist = [dict(h) for h in jt.fit(5, log_every=1)]
    with redirect_stdout(tbuf):
        thist = [dict(h) for h in tt.fit(5, log_every=1)]
    jlog, tlog = jbuf.getvalue(), tbuf.getvalue()

    assert [h["n_active"] for h in thist] == [h["n_active"] for h in jhist] == [2, 2, 2, 3, 3]
    assert [h["step"] for h in thist] == [1, 2, 3, 4, 5]
    # the same decisions at the event, line for line (numbers aside)
    decisions = lambda log: [w for line in log.splitlines() if line.startswith("[activate")  # noqa: E731
                             for w in ("accepted", "REJECTED", "skipped", "re-arms", "declined") if w in line]
    assert decisions(tlog) == decisions(jlog) and "view 2 (pnp med_reproj" in tlog
    # before the event: three steps on the same draws, metrics to 1e-3
    # (step 0 alone holds 1e-4; the grids' Adam steps add their noise)
    for jh, th in zip(jhist[:3], thist[:3]):
        assert set(jh) == set(th)
        for k in jh:
            np.testing.assert_allclose(th[k], jh[k], rtol=1e-3, atol=1e-5, err_msg=f"step {jh['step']} {k}")
    # the activated pose: PnP on anchors from probes that took three steps
    # apart, then four warmup Adam steps of 3e-3 against scenes that did
    jp, tp = np.asarray(jt.state.poses_pnp), tt.poses_pnp.numpy()
    np.testing.assert_allclose(tp[:2], jp[:2], rtol=0, atol=1e-6)
    np.testing.assert_allclose(tp[2], jp[2], rtol=0, atol=5e-3)
    np.testing.assert_allclose(tt.current_pose_host(), jt.current_pose_host(), rtol=0, atol=5e-3)
    assert tt._k_phase == jt._k_phase and tt._mask_k == jt._mask_k
    # after the event: the losses of steps 3 and 4 with three views
    for jh, th in zip(jhist[3:], thist[3:]):
        for k in ("loss_total", "loss_render", "psnr_scene", "psnr_obj", "s_val"):
            np.testing.assert_allclose(th[k], jh[k], rtol=2e-2, err_msg=f"step {jh['step']} {k}")


def test_ba_polish_and_reregistration_events(pair):
    """`polish_poses_ba` on the state `fit` left: the same polished poses as
    the JAX trainer's from the same current poses (1e-5, both through OpenCV's
    triangulation), refinement rows restarted; then `reregister_poses` and
    `validate` on the port."""
    jt, tt = pair
    convert.load_trainer_state(tt, _state_np(jt), mask_arr=np.asarray(jt.mask_arr), mask_k=jt._mask_k,
                               k_phase=jt._k_phase)
    assert tt.n_active == 3
    np.testing.assert_allclose(tt.current_pose_host(), jt.current_pose_host(), atol=1e-7)
    with redirect_stdout(io.StringIO()):
        jinfo, tinfo = jt.polish_poses_ba(), tt.polish_poses_ba()
    assert tinfo["applied"] == jinfo["applied"]
    np.testing.assert_allclose(tt.poses_pnp.numpy(), np.asarray(jt.state.poses_pnp), atol=1e-5)
    if tinfo["applied"]:
        assert not tt.pose_params["se3_refine"][:3].any()
    # re-registration against the scene's depth: the solve itself is held in
    # `test_activation_anchor_modes_match[scene]`; after five steps the scene's
    # depth is noise, RANSAC on it amplifies float32 differences into another
    # consensus set, so here only the event's bookkeeping is held
    tt.pose_params = dict(tt.pose_params, se3_refine=torch.full_like(tt.pose_params["se3_refine"], 1e-3))
    cur = tt.current_pose_host()
    with redirect_stdout(io.StringIO()):
        tt.reregister_poses()
    new = tt.poses_pnp.numpy()
    np.testing.assert_allclose(new[0], cur[0], atol=1e-7)            # view 0 keeps its current pose
    for i in (1, 2):
        np.testing.assert_allclose(new[i][:, :3] @ new[i][:, :3].T, np.eye(3), atol=1e-4)
        assert not np.allclose(new[i], cur[i - 1])                   # never the neighbour's pose
    assert not tt.pose_params["se3_refine"][:3].any()
    assert np.isfinite(tt.validate(1)) and tt.best_val > 0


# ---------------------------------------------------------------- protocols and probe health (port)


def _protocol_trainer(noise=0.0, **cam):
    data = t_make(n_train=3, n_test=1, H=32, W=32, seed=0, n_matches=16)
    _, tc = _configs(data, cam=dict(incremental=True, noise=noise, incremental_step=4, **cam),
                     pnp=dict(use_pnp=False), oc_over=dict(N_iters=100),
                     ot=dict(N_iters=100, N_rand=32, lr_pose=1e-3, lr_pose_end=1e-4),
                     sm=dict(SM, rand_rays=48, max_iter=200, fine_sampling=False),
                     st=dict(max_iter=200, precrop_iters=0))
    return TJointTrainer(tc, data, seed=0, device="cpu")


def test_noise_seed_composition():
    """noise > 0, no PnP: poses_pnp = noise o GT, every pose refined (no gauge anchor)."""
    t = _protocol_trainer(noise=0.3)
    seeded, gt = t.poses_pnp.numpy().astype(np.float64), t.poses_gt.numpy().astype(np.float64)
    assert np.abs(seeded - gt).max() > 1e-2
    for i in range(3):
        R = seeded[i][:, :3]
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
        # seeded = noise o GT with a noise of the configured size
        rel = talign.compose_pair_host(talign._invert(gt[i]), seeded[i])
        angle = np.degrees(np.arccos(np.clip((np.trace(rel[:, :3]) - 1) / 2, -1, 1)))
        assert 0.5 < angle < 90.0
    assert t.fix_first_pose is False


def test_gt_seed_composition():
    t = _protocol_trainer(noise=0.0)
    np.testing.assert_allclose(t.poses_pnp.numpy(), t.poses_gt.numpy(), atol=1e-7)


def test_activation_seeds_from_noisy_gt_not_pnp():
    t = _protocol_trainer(noise=0.3)
    assert t.n_active == 2
    buf = io.StringIO()
    with redirect_stdout(buf):
        t.maybe_activate_view(3)        # not a multiple of incremental_step: nothing happens
        assert t.n_active == 2
        t.maybe_activate_view(4)
    assert t.n_active == 3
    assert "seed (gt+noise)" in buf.getvalue(), buf.getvalue()
    assert "match refine" not in buf.getvalue()      # no-PnP protocols are not snapped to match geometry
    np.testing.assert_allclose(t.current_pose_host()[2], t.poses_pnp[2].numpy(), atol=1e-5)
    with redirect_stdout(buf):
        t.maybe_activate_view(8)        # every view is active: nothing left to do
    assert t.n_active == 3


def test_pose_refinement_live_in_noise_regime():
    t = _protocol_trainer(noise=0.3)
    t.step()
    per_view = t.pose_params["se3_refine"].abs().max(dim=1).values.numpy()
    assert per_view[0] > 0.0 and per_view[1] > 0.0, per_view
    assert per_view[2] == 0.0, per_view


def _tiny_trainer(n_iters=2, probe_health_check=True):
    data = t_make(n_train=3, n_test=1, H=20, W=20, seed=0)
    margin = float(data.xyz_max[0])
    cfg = tcfg.ExperimentConfig(
        data=tcfg.DataConfig(near=data.near, far=data.far),
        camera=tcfg.CameraConfig(incremental=False, barf_c2f=None),
        pnp=tcfg.PnPConfig(use_pnp=False),
        object_model=TObjectConfig(xyz_min=(-margin,) * 3, xyz_max=(margin,) * 3, num_voxels=16 ** 3,
                                   num_voxels_base=16 ** 3, N_iters=n_iters, barf_c2f=None,
                                   world_bound_scale=1.25),
        object_train=tcfg.ObjectTrainConfig(N_iters=n_iters, N_rand=32, decay_step_module=(), tv_updates=(),
                                            weight_tv_density=0.0, weight_tv_k0=0.0,
                                            probe_health_check=probe_health_check),
        scene_model=TSceneConfig(layers_feat=(16,) * 3, layers_rgb=(16, 3), skip=(), L_3D=2, L_view=1,
                                 sample_intvs=8, sample_intvs_fine=8, rand_rays=24, max_iter=100,
                                 barf_c2f=None, fine_sampling=False, matmul_dtype="float32"),
        scene_train=tcfg.SceneTrainConfig(max_iter=100, start_ratio_depth_cons=None))
    return TJointTrainer(cfg, data, seed=0, device="cpu")


def _evaporate(t):
    t.obj_params = dict(t.obj_params, sdf_grid=t.obj_params["sdf_grid"].abs() + 0.1)


def test_healthy_probe_passes():
    stats = _tiny_trainer().check_probe_health()
    assert stats["healthy"] and stats["n_neg"] >= 8


@pytest.mark.parametrize("kind", ["EVAPORATED", "FILLED BOX"])
def test_dead_probe_raises(kind):
    t = _tiny_trainer()
    g = t.obj_params["sdf_grid"].abs() + 0.1
    t.obj_params = dict(t.obj_params, sdf_grid=g if kind == "EVAPORATED" else -g)
    with pytest.raises(ProbeHealthError, match=kind):
        t.check_probe_health()


def test_fit_aborts_on_evaporated_probe_at_phase_end():
    t = _tiny_trainer(n_iters=2)
    _evaporate(t)
    with pytest.raises(ProbeHealthError):
        t.fit(5)
    assert t._probe_checked and t.global_step == 2     # one-shot, consumed before the raise
    t.fit(1)                                           # a caller that caught it can go on
    assert t.global_step == 3


def test_check_disabled_warns_but_continues():
    t = _tiny_trainer(n_iters=2, probe_health_check=False)
    _evaporate(t)
    buf = io.StringIO()
    with redirect_stdout(buf):
        stats = t.check_probe_health()
        t.fit(5)
    assert not stats["healthy"] and "WARNING" in buf.getvalue()
    assert t.global_step >= 5


def test_fit_logs_and_trips_on_a_non_finite_loss():
    t = _tiny_trainer(n_iters=50)
    seen = []
    hist = t.fit(4, log_every=2, callback=seen.append)
    assert [h["step"] for h in hist] == [2, 4] and seen == hist
    assert all(np.isfinite(h["loss_total"]) and h["n_active"] == 3 for h in hist)
    t.scene_params["nerf"]["feat"][0]["w"].fill_(float("nan"))
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        t.fit(1, log_every=1)


def test_chord_k_rebound_only_grows():
    """`update_plastic_chord_k`: a camera moved so that its in-box chords grow
    takes K with it; moved back, K stays (it only grows), capped by n_samples."""
    t = ttrainer.build_trainer(small=True, device="cpu", matmul_dtype="float32")
    k0 = t._k_phase
    assert t._mask_k == k0 < t.cfg.object_model.n_samples
    t.global_step = 1
    t.update_plastic_chord_k()
    assert t._k_phase == k0
    far = t.poses_pnp.clone()
    # view 1 turned about the box so that its rays run along the box diagonal
    turn = talign.se3_to_SE3_host(np.array([[0.6, 0.6, 0.0, 0.0, 0.0, 0.0]]))[0]
    near = far.clone()
    near[1] = torch.tensor(talign.compose_pair_host(turn, far[1].numpy()), dtype=torch.float32)
    t.poses_pnp = near
    with redirect_stdout(io.StringIO()):
        t.update_plastic_chord_k()
    k1 = t._k_phase
    assert k0 < k1 <= t.cfg.object_model.n_samples and t._mask_k == k1
    t.poses_pnp = far
    t.refresh_maskcache()                              # past step 0 the refresh re-bounds too
    assert t._k_phase == k1 == t._mask_k and t.mask_arr.all()
    m = t.step()                                       # and the step renders with the new K
    assert np.isfinite(m["loss_total"].item())
    t.global_step = t.cfg.object_train.N_iters + 1
    t.poses_pnp = near
    t._k_phase = k0
    t.update_plastic_chord_k()                         # past the plastic phase: no re-bound
    assert t._k_phase == k0


# ---------------------------------------------------------------- the activation's branches (port)


@pytest.mark.parametrize("cam,pnp,expect", [
    (dict(activation_pose_warmup=2, activation_warmup_gate_px=50.0), dict(use_pnp=True),
     ["warmup skipped (PnP med reproj"]),
    (dict(activation_pose_warmup=2, activation_warmup_gate_px=50.0, activation_warmup_holdout_px=1e-9),
     dict(use_pnp=True), ["holdout gate re-arms warmup", "warmup accepted|warmup REJECTED"]),
    (dict(activation_pose_warmup=2, activation_warmup_gate_px=50.0, activation_warmup_photo_ratio=1e-9),
     dict(use_pnp=True), ["photo gate re-arms warmup", "warmup accepted|warmup REJECTED"]),
    (dict(activation_pose_warmup=2, activation_warmup_gate_px=50.0, activation_warmup_photo_ratio=1e9),
     dict(use_pnp=True), ["warmup skipped", "photo mse"]),
    (dict(activation_pose_warmup=2, activation_warmup_rot_only=True, activation_warmup_center_anchor=1.0),
     dict(use_pnp=True), ["(warmup): rel-pose error"]),
    (dict(activation_pose_warmup=2, activation_rescue_ratio=1e-9), dict(use_pnp=True),
     ["rescue tournament", "-> kept|-> prev|-> warm-prev"]),
    (dict(activation_rescue_ratio=1e-9), dict(use_pnp=True), ["rescue tournament", "-> kept|-> prev"]),
    (dict(activation_match_refine_px=1e-9), dict(use_pnp=True), ["match refine accepted|match refine declined"]),
    (dict(), dict(use_pnp=True, anchor="scene"), ["view 2 (pnp med_reproj"]),
    (dict(), dict(use_pnp=True, anchor="object_scaled"), ["view 2 (pnp med_reproj"]),
    (dict(), dict(use_pnp=False, use_identical=True), ["seed (prev view)"]),
], ids=["px_gate_skips", "holdout_rearms", "photo_rearms", "photo_agrees", "rot_only_unguarded", "rescue_with_warmup",
        "rescue_without_warmup", "match_refine_forced", "anchor_scene", "anchor_object_scaled", "identical"])
def test_activation_branches(cam, pnp, expect, numpy_pnp):
    """Every branch of `maybe_activate_view` on the port's trainer: the px gate
    and its two second opinions, the unguarded rot-only warmup, the rescue
    tournament with and without a warmup, a forced match refinement, the
    three anchor modes and the identical-pose protocol. Each run must log its
    branch, activate the view and leave a rigid, finite pose."""
    data = t_make(**SCENE)
    _, tc = _configs(data, cam=dict(incremental=True, incremental_step=4, **cam), pnp=pnp)
    t = TJointTrainer(tc, data, seed=0, device="cpu")
    buf = io.StringIO()
    with redirect_stdout(buf):
        t.maybe_activate_view(4)
    log = buf.getvalue()
    for alternatives in expect:
        assert any(a in log for a in alternatives.split("|")), (alternatives, log)
    assert t.n_active == 3
    pose = t.poses_pnp[2].numpy().astype(np.float64)
    assert np.isfinite(pose).all()
    np.testing.assert_allclose(pose[:, :3] @ pose[:, :3].T, np.eye(3), atol=1e-4)
    assert np.linalg.det(pose[:, :3]) > 0.99
    if pnp.get("use_identical"):
        np.testing.assert_allclose(pose, t.current_pose_host()[1], atol=1e-6)
    assert t._mask_k == t._k_phase      # the chord bound was taken again for the new camera set
