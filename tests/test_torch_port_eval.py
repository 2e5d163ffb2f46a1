"""The port's evaluation and export modules held against the JAX package's.

On the same numpy inputs, with the params carried by `convert.py`:

* `eval/evaluator.evaluate_full`, with test-time pose optimization on the JAX
  draws (`ray_idx`) and without it: PSNR / SSIM (mean, median, per image)
  within 1e-4, pose errors within 1e-4 deg (x100 for translation), depth
  errors within 1e-4; the panels it writes (the port's PNG writer, read back
  by imageio): the gt tile equal, the rendered rgb and opacity tiles within 1
  of 255 (a value within float32 rounding of the reference's can round to the
  next uint8), the depth tile within one step of the turbo table (its colour
  index can move by one);
* `JointTrainer.render_full_image`, `object_sdf.extract_sdf_volume`,
  `object_sdf.mesh_color_forward` and `utils/vis.render_object_image`: float32,
  within 1e-5 of max(1, the output's largest magnitude) (the volume reaches
  |4| and the depth variance exceeds 1, where float32 sums in another order
  differ by more than 1e-5 absolute);
* `eval/mesh.py` on the same volume: identical vertices and triangles on the
  native and on the numpy path, identical component filter, surface samples,
  nearest distances, chamfer and PLY bytes;
* `eval/dtu_protocol.py` (STL reader, culls, ICP, `evaluate_mesh_dtu`) and
  `data/synthetic.probe_surface_points`: equal, 1e-6 where the ICP's SVD
  runs;
* the four pose paths of `eval/video.py`: 1e-6; `colorize_depth` and
  `validation_panel` bit-equal to JAX's (matplotlib's turbo);
  `render_video` without imageio writes its PNG frames;
* `utils/logging.py` and `utils/profiling.py`.
"""
import builtins
import json
import os

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseprobe_tpu.data import synthetic as jsynth
from poseprobe_tpu.eval import dtu_protocol as jdtu, evaluator as jeval, mesh as jmesh, video as jvideo
from poseprobe_tpu.models import object_sdf as jobject, scene_nerf as jscene
from poseprobe_tpu.models.scene_nerf import SceneConfig as JSceneConfig
from poseprobe_tpu.utils import vis as jvis
from poseprobe_tpu_torch import convert
from poseprobe_tpu_torch.data import synthetic as tsynth
from poseprobe_tpu_torch.eval import (dtu_protocol as tdtu, evaluator as teval, mesh as tmesh, turbo as tturbo,
                                      video as tvideo)
from poseprobe_tpu_torch.models import object_sdf as tobject
from poseprobe_tpu_torch.models.scene_nerf import SceneConfig as TSceneConfig
from poseprobe_tpu_torch.utils import logging as tlogging, profiling as tprofiling, vis as tvis
from test_torch_port_joint_step import SM, _carry_state, _leave_the_init_state, _np, _trainers

torch.set_num_threads(1)

TEST_ITER = 3


def _close(got, ref, what=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * max(1.0, float(np.abs(ref).max())), err_msg=what)


def _jax_warmup_draws(seed, n_iters, rand_rays, n_pix):
    """The ray indices JAX's `test_time_pose_optim` draws from `seed`."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n_iters):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(sub, (rand_rays,), 0, n_pix)))
    return np.stack(out)


@pytest.fixture(scope="module")
def scene():
    data = jsynth.make_synthetic_scene(n_train=3, n_test=2, H=32, W=32, seed=0, n_matches=32)
    jp = jscene.init_scene_params(jax.random.PRNGKey(4), JSceneConfig(**SM))
    return data, jp, convert.scene_params_from_jax(_np(jp), "cpu")


@pytest.fixture(scope="module")
def pair():
    """(JAX trainer, port trainer) with the same state off the init kinks and
    a seeded SDF grid with surface inside the box."""
    jt, tt = _trainers(incremental=True)
    _leave_the_init_state(jt)
    obj = dict(jt.state.obj_params)
    obj["sdf_grid"] = obj["sdf_grid"] + jnp.asarray(
        np.random.default_rng(3).normal(0, 0.05, obj["sdf_grid"].shape), jnp.float32)
    jt.state.obj_params = obj
    jt.state.step = 30
    _carry_state(jt, tt)
    return jt, tt


@pytest.mark.parametrize("test_photo", [True, False], ids=["test_optim", "no_test_optim"])
def test_evaluate_full_matches(scene, test_photo, tmp_path):
    data, jp, tp = scene
    it, ie = data.i_train, data.i_test
    noise = np.random.default_rng(1).normal(0, 0.01, data.poses_gt_w2c[it].shape).astype(np.float32)
    cur = data.poses_gt_w2c[it] + noise
    depth_gt = data.depth_gt[ie]
    args = (cur, data.poses_gt_w2c[it], data.images[ie], data.poses_gt_w2c[ie], data.Ks[ie], (data.near, data.far))
    kw = dict(test_photo=test_photo, test_iter=TEST_ITER, progress=0.4, test_depth_gt=depth_gt)
    ref = jeval.evaluate_full(jp, JSceneConfig(**SM), *(jnp.asarray(a) if i in (1, 3, 4) else a
                                                       for i, a in enumerate(args[:5])), args[5],
                              save_dir=str(tmp_path / "jax"), **kw)
    idx = [_jax_warmup_draws(t, TEST_ITER, 1024, 32 * 32) for t in range(len(ie))]
    got = teval.evaluate_full(tp, TSceneConfig(**SM), *args, save_dir=str(tmp_path / "port"), ray_idx=idx, **kw)
    assert set(got) == set(ref) and "depth_abs" in got and "lpips" not in got
    for k in ("psnr", "psnr_median", "ssim", "ssim_median", "depth_abs", "depth_rmse"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-4, err_msg=k)
    for k in ("psnr_per_img", "ssim_per_img", "depth_abs_per_img"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-4, err_msg=k)
    for k in ("rot_error", "trans_error"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-4, err_msg=k)
    for t in range(len(ie)):
        a = imageio.imread(tmp_path / "jax" / f"test_{t:03d}.png")
        b = imageio.imread(tmp_path / "port" / f"test_{t:03d}.png")
        assert a.shape == b.shape == (32, 4 * 32, 3) and b.dtype == np.uint8
        diff = np.abs(a.astype(int) - b.astype(int))
        assert not diff[:, :32].any()
        assert diff[:, 32:64].max() <= 1 and diff[:, 96:].max() <= 1
        turbo_step = np.ceil(np.abs(np.diff(tturbo.TURBO, axis=0)).max() * 255) + 1
        assert diff[:, 64:96].max() <= turbo_step


def test_render_full_image_matches(pair):
    jt, tt = pair
    for i in range(2):
        ref = jt.render_full_image(jt.poses_gt[i], jt.Ks[i], chunk=300)
        got = tt.render_full_image(tt.poses_gt[i], tt.Ks[i], chunk=300)
        assert set(got) == set(ref)
        for k in ref:
            _close(got[k].numpy(), ref[k], k)


def test_sdf_volume_and_mesh_colours_match(pair):
    jt, tt = pair
    jo, om = jt.state.obj_params, jt.cfg.object_model
    for use_deform in (True, False):
        ref = jobject.extract_sdf_volume(jo, om, resolution=20, use_deform=use_deform, chunk=1000)
        got = tobject.extract_sdf_volume(tt.obj_params, tt.cfg.object_model, resolution=20, use_deform=use_deform,
                                         chunk=1000)
        assert got.shape == (20, 20, 20) and (got > 0).any() and (got < 0).any()
        _close(got, ref)
    pts = np.random.default_rng(2).uniform(-0.4, 0.4, (3000, 3)).astype(np.float32)
    ref = jobject.mesh_color_forward(jo, om, pts, chunk=1000)
    got = tobject.mesh_color_forward(tt.obj_params, tt.cfg.object_model, pts, chunk=1000)
    assert got.shape == (3000, 3)
    _close(got, ref)


def test_object_image_matches(pair):
    jt, tt = pair
    kw = dict(H=12, W=16, inverse_y=jt.data.inverse_y, near=jt.data.near, far=jt.data.far, chunk=100)
    ref = jvis.render_object_image(jt.state.obj_params, jt.cfg.object_model, jt.poses_gt[1], jt.Ks[1], **kw)
    got = tvis.render_object_image(tt.obj_params, tt.cfg.object_model, tt.poses_gt[1], tt.Ks[1], **kw)
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k].numpy(), ref[k], k)


@pytest.fixture(scope="module")
def volume():
    """A smooth random volume with several surface components."""
    rng = np.random.default_rng(0)
    g = np.stack(np.meshgrid(*[np.linspace(-1, 1, 18)] * 3, indexing="ij"), -1)
    centres = rng.uniform(-0.7, 0.7, (4, 3))
    radii = np.array([0.45, 0.2, 0.12, 0.05])
    d = np.min(np.linalg.norm(g[..., None, :] - centres, axis=-1) - radii, axis=-1)
    return (-d).astype(np.float32)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_mesh_functions_match(volume, native, tmp_path, monkeypatch):
    if native:
        assert tmesh.native_path() == "native" and jmesh._load_native() is not None
    else:       # both modules' fallbacks: their native libraries made unavailable
        monkeypatch.setattr(jmesh, "_load_native", lambda: None)
        monkeypatch.setattr(tmesh, "_load_native", lambda: None)
    ref = jmesh.marching_cubes(volume)
    got = tmesh.marching_cubes(volume)
    assert len(got[1]) > 100
    for a, b in zip(ref, got):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    lo, hi, scale = (-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), np.diag([2.0, 2.0, 2.0, 1.0])
    scale[:3, 3] = [0.1, 0.2, 0.3]
    verts, tris = tmesh.extract_mesh_world(volume, lo, hi, scale_mat=scale)
    jv, jtr = jmesh.extract_mesh_world(volume, lo, hi, scale_mat=scale)
    assert np.array_equal(verts, jv) and np.array_equal(tris, jtr)
    fv, ft, finfo = tmesh.filter_small_components(verts, tris, min_area_frac=0.1)
    rv, rt, rinfo = jmesh.filter_small_components(jv, jtr, min_area_frac=0.1)
    assert finfo == rinfo and finfo["components"] > finfo["components_kept"] >= 1
    assert np.array_equal(fv, rv) and np.array_equal(ft, rt)
    pa = tmesh.sample_mesh_surface(fv, ft, 2000, seed=3)
    assert np.array_equal(pa, jmesh.sample_mesh_surface(rv, rt, 2000, seed=3))
    pb = np.random.default_rng(5).uniform(-2, 2, (500, 3))
    assert tmesh.native_path() == ("native" if native else "numpy")
    assert np.array_equal(tmesh.nearest_sqdist(pb, pa), jmesh.nearest_sqdist(pb, pa))
    assert tmesh.chamfer_distance(pa, pb, max_dist=0.5) == jmesh.chamfer_distance(pa, pb, max_dist=0.5)
    tmesh.save_ply(str(tmp_path / "a.ply"), fv, ft)
    jmesh.save_ply(str(tmp_path / "b.ply"), rv, rt)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    assert tmesh.sample_mesh_surface(fv[:0], ft[:0], 10).shape == (0, 3)


def _write_ply(path, pts, binary: bool):
    header = (f"ply\nformat {'binary_little_endian' if binary else 'ascii'} 1.0\nelement vertex {len(pts)}\n"
              "property float x\nproperty float y\nproperty float z\nend_header\n").encode()
    with open(path, "wb") as f:
        f.write(header)
        if binary:
            f.write(np.asarray(pts, "<f4").tobytes())
        else:
            f.write("".join(f"{x} {y} {z}\n" for x, y, z in pts).encode())


@pytest.mark.parametrize("probe", ["cube", "sphere"])
def test_dtu_protocol_and_probe_surface_match(probe, tmp_path):
    gt = tsynth.probe_surface_points(n=3000, probe=probe, seed=1)
    assert np.array_equal(gt, jsynth.probe_surface_points(n=3000, probe=probe, seed=1))
    for binary in (True, False):
        path = str(tmp_path / f"stl_{binary}.ply")
        _write_ply(path, gt.astype(np.float32), binary)
        got, ref = tdtu.load_stl_points(path, max_points=2000), jdtu.load_stl_points(path, max_points=2000)
        assert got.shape == (2000, 3) and np.array_equal(got, ref)
    data = jsynth.make_synthetic_scene(n_train=3, n_test=1, H=32, W=32, seed=0, probe=probe)
    tr = data.i_train
    pts = np.random.default_rng(2).uniform(-0.6, 0.6, (4000, 3))
    culls = [(tdtu.visual_hull_cull, jdtu.visual_hull_cull, (data.masks[tr], data.poses_gt_w2c[tr], data.Ks[tr])),
             (tdtu.visible_in_any_view, jdtu.visible_in_any_view,
              (data.depth_gt[tr], data.poses_gt_w2c[tr], data.Ks[tr])),
             (tdtu.observed_space_cull, jdtu.observed_space_cull,
              (data.depth_gt[tr], data.poses_gt_w2c[tr], data.Ks[tr]))]
    for ours, theirs, a in culls:
        keep = ours(pts, *a)
        assert keep.any() and not keep.all() and np.array_equal(keep, theirs(pts, *a))
    # a noisy, scaled copy of the surface as the "prediction"
    rng = np.random.default_rng(4)
    pred = gt * 1.05 + rng.normal(0, 0.01, gt.shape)
    np.testing.assert_allclose(tdtu.icp_refine_sim3(pred, gt), jdtu.icp_refine_sim3(pred, gt), rtol=0, atol=1e-6)
    verts, tris = jmesh.marching_cubes(-np.asarray(jsynth._probe_sdf(
        np.stack(np.meshgrid(*[np.linspace(-0.6, 0.6, 16)] * 3, indexing="ij"), -1), 0.35, probe), np.float32))
    verts = (verts / 15.0 * 1.2 - 0.6).astype(np.float32)
    cull = lambda p: jdtu.visual_hull_cull(p, data.masks[tr], data.poses_gt_w2c[tr], data.Ks[tr])  # noqa: E731
    kw = dict(bbox=np.stack([gt.min(0) - 0.15, gt.max(0) + 0.15]), max_dist=0.5, n_samples=5000)
    got = tdtu.evaluate_mesh_dtu(verts, tris, gt, pred_cull=cull, gt_cull=cull, **kw)
    ref = jdtu.evaluate_mesh_dtu(verts, tris, gt, pred_cull=cull, gt_cull=cull, **kw)
    assert set(got) == set(ref) and "overall_icp" in got
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-6, err_msg=k)
    empty = tdtu.evaluate_mesh_dtu(verts[:0], tris[:0], gt)
    assert empty == jdtu.evaluate_mesh_dtu(verts[:0], tris[:0], gt) and empty["empty_mesh"]


def test_pose_paths_match():
    data = jsynth.make_synthetic_scene(n_train=4, n_test=1, H=16, W=16, seed=0)
    w2c = data.poses_gt_w2c[data.i_train]
    c2w = np.linalg.inv(np.concatenate([w2c, np.tile([[[0, 0, 0, 1.0]]], (len(w2c), 1, 1))], 1))[:, :3]
    c2w = c2w.astype(np.float32)
    ref = np.asarray(jvideo.oscillation_poses(jnp.asarray(w2c[0]), n=7, scale=0.5))
    got = tvideo.oscillation_poses(w2c[0], n=7, scale=0.5).numpy()
    assert got.shape == (7, 3, 4)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    for fn, kw in (("spiral_poses_from_trajectory", dict(n=9)), ("interp_poses_slerp", dict(n_views=9)),
                   ("interp_poses_bspline", dict(n_views=9))):
        got, ref = getattr(tvideo, fn)(c2w, **kw), getattr(jvideo, fn)(c2w, **kw)
        assert got.shape == (9, 3, 4) and got.dtype == ref.dtype
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6, err_msg=fn)


def test_colorize_depth_and_panel_are_bit_equal():
    rng = np.random.default_rng(0)
    for dtype in (np.float32, np.float64):
        depth = rng.uniform(1.0, 5.0, (17, 19)).astype(dtype)
        depth[0, :3] = [depth.min(), depth.max(), np.nan]
        for d_range in (None, (2.0, 4.0), (0.5, 8.5)):
            got, ref = tvideo.colorize_depth(depth, d_range), jvideo.colorize_depth(depth, d_range)
            assert got.dtype == np.uint8 and np.array_equal(got, ref), (dtype, d_range)
    grid = np.linspace(0.0, 1.0, 4097, dtype=np.float32)
    assert np.array_equal(tvideo.colorize_depth(grid[None], (0.0, 1.0)), jvideo.colorize_depth(grid[None], (0.0, 1.0)))
    gt, pred = rng.uniform(-0.1, 1.1, (2, 9, 11, 3))
    depth, op = rng.uniform(1, 3, (9, 11, 1)), rng.uniform(-0.2, 1.2, (9, 11))
    for opacity in (op, None):
        got, ref = tvis.validation_panel(gt, pred, depth, opacity), jvis.validation_panel(gt, pred, depth, opacity)
        assert np.array_equal(got, ref)


def test_render_video_writes_png_frames_without_imageio(scene, tmp_path, monkeypatch):
    data, jp, tp = scene
    poses = data.poses_gt_w2c[data.i_train[:2]]
    real_import = builtins.__import__

    def no_imageio(name, *a, **k):
        if name == "imageio" or name.startswith("imageio."):
            raise ImportError(name)
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_imageio)
    out = tvideo.render_video(tp, TSceneConfig(**SM), poses, data.Ks[0], 32, 32, (data.near, data.far),
                              str(tmp_path / "spiral_rgb.mp4"), depth_out_path=str(tmp_path / "spiral_depth.mp4"))
    monkeypatch.undo()
    assert out == str(tmp_path / "spiral_rgb_frames")
    frames = sorted(os.listdir(out))
    assert frames == ["frame_0000.png", "frame_0001.png"]
    assert sorted(os.listdir(tmp_path / "spiral_depth_frames")) == frames
    render = teval.render_full(tp, TSceneConfig(**SM), poses[1], data.Ks[0], 32, 32, (data.near, data.far))
    want = (np.clip(render["rgb"].numpy(), 0, 1) * 255).astype(np.uint8)
    assert np.array_equal(imageio.imread(os.path.join(out, "frame_0001.png")), want)


def test_logging_and_profiling_helpers(tmp_path):
    log = tlogging.MetricsLogger(str(tmp_path / "m" / "metrics.jsonl"))
    log.log({"step": 1, "loss": 0.5})
    log.log({"step": 2, "loss": 0.25})
    log.close()
    rows = [json.loads(line) for line in (tmp_path / "m" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2] and all("wall_time" in r for r in rows)
    timer = tlogging.Timer()
    assert timer.lap("a") >= 0.0 and set(timer.laps) == {"a"}
    meter = tprofiling.RaysPerSecond(window=3)
    assert meter.update(10) == 0.0 and meter.update(10) > 0.0
    with tprofiling.trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert (tmp_path / "trace" / "trace.json").exists()
    ok = tprofiling.nan_debug(lambda x: {"y": x * 2})(torch.ones(3))
    assert torch.equal(ok["y"], torch.full((3,), 2.0))
    with pytest.raises(FloatingPointError):
        tprofiling.nan_debug(lambda x: [x / 0.0])(torch.zeros(2))
