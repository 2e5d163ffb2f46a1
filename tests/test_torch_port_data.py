"""The port's data slice held against the JAX package: the PNG reader, the six
dataset loaders, the matcher and the configuration with its presets; and a
`JointTrainer` built from every preset on a fixture of its dataset layout.

The PNG reader must return what `imageio.imread` returns, bit for bit. Each
loader reads a tiny fixture in its own layout (rendered from the synthetic
scene with its noise texture, so the classical matcher finds matches), once
through the JAX loader and once through the port's: every array of the two
`SceneData` must be equal (`array_equal`; the same OpenCV in one process
matches the same pixels). Presets: `dataclasses.asdict` of every
`get_config(...)` equal to the reference's, over the family presets' tables.
"""
import dataclasses
import importlib
import json
import os
import struct
import subprocess
import sys
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from poseprobe_tpu.config import config as jcfg
from poseprobe_tpu.data import loaders as jloaders
from poseprobe_tpu.pose_init import matching as jmatching
from poseprobe_tpu_torch.config import config as tcfg
from poseprobe_tpu_torch.data import loaders as tloaders, png, synthetic as tsyn
from poseprobe_tpu_torch.pose_init import matching as tmatching
from tools import dtu_fixture

torch.set_num_threads(1)

H, W = 24, 32
PRESETS = ("dtu_generic", "dtu_scan", "dtu_scan1", "nerf_synthetic", "replica_room0", "replica_room1",
           "replica_scene", "shapenet_car", "toy_candy", "toy_desk", "toy_scene")


# ---------------------------------------------------------------- PNG


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _png_with_every_filter(img: np.ndarray) -> bytes:
    """A PNG of `img` whose rows take the five filters in turn (an encoder
    written from the PNG specification, independent of `png.py`)."""
    body = (img.astype(">u2").view(np.uint8) if img.dtype == np.uint16 else img)
    rows = body.reshape(img.shape[0], -1).astype(np.int32)
    bpp = rows.shape[1] // img.shape[1]
    out = []
    for r in range(rows.shape[0]):
        x = rows[r]
        up = rows[r - 1] if r else np.zeros_like(x)
        left = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        f = r % 5
        pred = [0, left, up, (left + up) // 2, _paeth(left, up, upleft)][f]
        out.append(np.concatenate([[f], (x - pred) % 256]).astype(np.uint8))
    colour = {1: 0, 2: 4, 3: 2, 4: 6}[1 if img.ndim == 2 else img.shape[2]]
    header = struct.pack(">IIBBBBB", img.shape[1], img.shape[0], 8 * img.dtype.itemsize, colour, 0, 0, 0)
    return (dtu_fixture._SIGNATURE + dtu_fixture._chunk(b"IHDR", header)
            + dtu_fixture._chunk(b"IDAT", zlib.compress(np.concatenate(out).tobytes()))
            + dtu_fixture._chunk(b"IEND", b""))


def _filters_used(data: bytes) -> set:
    assert data[:8] == png._SIGNATURE
    pos, idat, header = 8, [], None
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        header = body if kind == b"IHDR" else header
        idat += [body] if kind == b"IDAT" else []
        pos += 12 + n
    w, h, depth, colour = struct.unpack(">IIBB", header[:10])
    stride = w * {0: 1, 2: 3, 4: 2, 6: 4}[colour] * depth // 8 + 1
    raw = zlib.decompress(b"".join(idat))
    return {raw[r * stride] for r in range(h)}


def _image(kind: str, seed: int) -> np.ndarray:
    """Smooth rows (which PIL's adaptive filtering codes with Sub, Up, Average
    or Paeth) above noisy rows."""
    rng = np.random.default_rng(seed)
    shape, top = {"grey": ((19, 23), 255), "grey_alpha": ((19, 23, 2), 255), "rgb": ((19, 23, 3), 255),
                  "rgba": ((19, 23, 4), 255), "grey16": ((19, 23), 65535)}[kind]
    dtype = np.uint16 if kind == "grey16" else np.uint8
    ramp = np.add.outer(np.arange(shape[0]) * 7, np.arange(shape[1]) * 5) % (top + 1)
    img = np.broadcast_to(ramp.reshape(shape[:2] + (1,) * (len(shape) - 2)), shape).astype(dtype)
    noisy = rng.integers(0, top + 1, shape, dtype=np.int64).astype(dtype)
    return np.concatenate([img[:10], noisy[10:]])


@pytest.mark.parametrize("kind", ["grey", "grey_alpha", "rgb", "rgba", "grey16"])
def test_png_reader_matches_imageio(kind, tmp_path):
    img = _image(kind, seed=len(kind))
    by_imageio = tmp_path / "imageio.png"
    imageio.imwrite(by_imageio, img)
    every = tmp_path / "filters.png"
    every.write_bytes(_png_with_every_filter(img))
    assert _filters_used(every.read_bytes()) == {0, 1, 2, 3, 4}
    ours = tmp_path / "ours.png"
    dtu_fixture.write_png(ours, img)
    for path in (by_imageio, every, ours):
        ref = np.asarray(imageio.imread(path))
        got = png.read_png(path)
        assert got.dtype == ref.dtype and got.shape == ref.shape, path
        assert np.array_equal(got, ref), path
        assert np.array_equal(got, img), path
        assert np.array_equal(png.imread(path), ref)


def test_png_reader_refuses_what_it_does_not_read(tmp_path):
    (tmp_path / "x.txt").write_bytes(b"not a png")
    with pytest.raises(ValueError):
        png.read_png(tmp_path / "x.txt")
    data = bytearray(dtu_fixture.encode_png(np.zeros((3, 4), np.uint8)))
    data[8 + 8 + 12] = 1                             # the IHDR's interlace byte
    with pytest.raises(ValueError, match="interlaced"):
        png.decode_png(bytes(data))


def test_jpeg_without_imageio_or_pil_names_the_file(tmp_path):
    path = tmp_path / "frame.jpg"
    imageio.imwrite(path, np.zeros((8, 8, 3), np.uint8))
    assert png.imread(path).shape == (8, 8, 3)
    code = ("import sys\nsys.modules['imageio'] = sys.modules['imageio.v2'] = sys.modules['PIL'] = None\n"
            "from poseprobe_tpu_torch.data import png\n"
            f"try:\n    png.imread({str(path)!r})\nexcept ImportError as e:\n    print('ImportError', e)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=60,
                         env=dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(__file__))))
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ImportError") and str(path) in out.stdout


# ---------------------------------------------------------------- fixtures in each layout


def _scene(n_views: int):
    return tsyn.make_synthetic_scene(n_train=3, n_test=n_views - 3, H=H, W=W, seed=0, texture="noise",
                                     n_matches=16)


def _u8(x):
    return np.round(np.clip(x, 0, 1) * 255).astype(np.uint8)


def _c2w(w2c):
    R, t = w2c[:3, :3].astype(np.float64), w2c[:3, 3].astype(np.float64)
    c2w = np.eye(4)
    c2w[:3, :3], c2w[:3, 3] = R.T, -R.T @ t
    return c2w


def _write_json_layout(root, scene, image_dir, write_view, c2w_of):
    """transforms_{train,val,test}.json over views 0-2 / 3 / 4-5."""
    os.makedirs(os.path.join(root, image_dir), exist_ok=True)
    for split, ids in (("train", (0, 1, 2)), ("val", (3,)), ("test", (4, 5))):
        frames = []
        for k in ids:
            name = f"{image_dir}/{split}_{k}"
            write_view(os.path.join(root, name), k)
            frames.append({"file_path": name, "transform_matrix": c2w_of(k).tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.9, "frames": frames}, f)


def write_fixture(layout: str, root: str) -> dict:
    """Write a tiny dataset in `layout` under `root`; returns the DataConfig
    fields that point a config at it (and the loader's extra arguments)."""
    blender_flip = np.diag([1.0, -1.0, -1.0, 1.0])
    if layout == "dtu":
        root = os.path.join(root, "DTU", "scan_fixture")      # masks at .../idrmasks/scan_fixture
        dtu_fixture.write_dtu(root, _scene(9))
        return dict(datadir=root, selected_id=(0, 1, 2), test_id=None)
    scene = _scene(6)
    if layout == "blender":
        def view(path, k):
            rgba = np.concatenate([scene.images[k], scene.masks[k]], axis=-1)
            imageio.imwrite(path + ".png", _u8(rgba))
        _write_json_layout(root, scene, "imgs", view, lambda k: _c2w(scene.poses_gt_w2c[k]) @ blender_flip)
        return dict(datadir=root, selected_id=(0, 1, 2), test_id=None, trainskip=1)
    if layout == "toy":
        def view(path, k):
            imageio.imwrite(path + ".png", _u8(scene.images[k]))
            imageio.imwrite(path + ".instance.png", np.where(scene.masks[k][..., 0] > 0, 1, 2).astype(np.uint8))

        def c2w(k):
            m = _c2w(scene.poses_gt_w2c[k])
            m[:3, 3] *= 5.0                                     # load_toy's pose_scale
            return m
        _write_json_layout(root, scene, "imgs", view, c2w)
        return dict(datadir=root, selected_id=(0, 1, 2), test_id=None)
    if layout == "scene_with_shapenet":
        os.makedirs(os.path.join(root, "mask"), exist_ok=True)

        def view(path, k):
            imageio.imwrite(path + ".png", _u8(scene.images[k]))
            imageio.imwrite(path.replace("colors", "mask") + ".png", _u8(scene.masks[k][..., 0]))
        _write_json_layout(root, scene, "colors", view, lambda k: _c2w(scene.poses_gt_w2c[k]) @ blender_flip)
        return dict(datadir=root, selected_id=(0, 1, 2), test_id=None)
    if layout == "custom":
        for sub in ("scene_image", "scene_mask"):
            os.makedirs(os.path.join(root, sub), exist_ok=True)
        w2c = np.tile(np.eye(4, dtype=np.float32), (6, 1, 1))
        w2c[:, :3, :4] = scene.poses_gt_w2c
        np.save(os.path.join(root, "w2c.npy"), w2c)
        np.savetxt(os.path.join(root, "intrinsics.txt"), scene.Ks[0])
        for k in range(6):
            imageio.imwrite(os.path.join(root, "scene_image", f"{k:05d}.jpg"), _u8(scene.images[k]))
            imageio.imwrite(os.path.join(root, "scene_mask", f"{k:05d}.jpg"), _u8(scene.masks[k][..., 0]))
        return dict(datadir=root, selected_id=(0, 1, 3), test_id=None)
    if layout == "replica":
        os.makedirs(os.path.join(root, "results"), exist_ok=True)
        for k in range(6):
            imageio.imwrite(os.path.join(root, "results", f"frame{k:06d}.jpg"), _u8(scene.images[k]))
            depth = np.where(scene.masks[k][..., 0] > 0, scene.depth_gt[k] * 6553.5, 0)
            imageio.imwrite(os.path.join(root, "results", f"depth{k:06d}.png"), depth.astype(np.uint16))
        np.savetxt(os.path.join(root, "traj.txt"), np.stack([_c2w(p).reshape(-1) for p in scene.poses_gt_w2c]))
        return dict(datadir=root, selected_id=(0, 1, 2), test_id=None)
    raise ValueError(layout)


LAYOUTS = [("dtu", {}), ("dtu", {"reso_level": 2}), ("blender", {}), ("blender", {"half_res": True}),
           ("toy", {}), ("custom", {}), ("replica", {}), ("scene_with_shapenet", {"object_center": (0.1, 0, -0.2)})]


def _assert_same_data(t, j):
    for f in dataclasses.fields(j):
        a, b = getattr(j, f.name), getattr(t, f.name)
        if f.name == "samplers":
            assert np.array_equal(b.pixels, a.pixels) and np.array_equal(b.counts, a.counts)
        elif isinstance(a, np.ndarray) or a is None:
            assert (b is None) == (a is None), f.name
            assert a is None or (b.dtype == a.dtype and np.array_equal(b, a)), f.name
        else:
            assert b == a, f.name


@pytest.mark.parametrize("layout,kwargs", LAYOUTS, ids=[f"{lay}{'-' + next(iter(kw)) if kw else ''}"
                                                        for lay, kw in LAYOUTS])
def test_loader_matches_jax(layout, kwargs, tmp_path):
    fields = write_fixture(layout, str(tmp_path))
    jd = jloaders.load_data(jcfg.DataConfig(dataset_type=layout, **fields), matcher_backend="classical",
                            **kwargs)
    td = tloaders.load_data(tcfg.DataConfig(dataset_type=layout, **fields), matcher_backend="classical",
                            **kwargs)
    _assert_same_data(td, jd)
    assert td.n_train == 3 and len(td.i_test) >= 1
    # the classical matcher ran (OpenCV is installed here), and found matches in every pack
    assert (td.scene_matches[..., 4] > 0).sum(axis=1).min() > 0
    if layout == "dtu":
        assert td.scale_mats.shape == (4, 4) and list(td.i_test) == [3]    # view 8 after the exclude list
    if layout == "replica":
        assert td.depth_gt is not None and td.depth_gt.max() > 0


def test_load_k_rt_from_p_and_the_dtu_writer_round_trip(tmp_path):
    scene = _scene(9)
    fields = write_fixture("dtu", str(tmp_path))
    data = tloaders.load_dtu(tcfg.DataConfig(dataset_type="dtu", **fields), matcher_backend="classical")
    np.testing.assert_allclose(data.poses_gt_w2c[:3], scene.poses_gt_w2c[:3], atol=1e-4)
    np.testing.assert_allclose(data.Ks, np.concatenate([scene.Ks[:3], scene.Ks[8:]]), rtol=1e-4, atol=1e-3)
    assert np.abs(data.images[:3] - scene.images[:3]).max() <= 0.5 / 255 + 1e-6
    assert os.path.isdir(os.path.join(str(tmp_path), "idrmasks", "scan_fixture", "mask"))
    P = np.random.default_rng(3).normal(size=(3, 4)).astype(np.float32)
    for a, b in zip(jloaders.load_K_Rt_from_P(P), tloaders.load_K_Rt_from_P(P)):
        assert np.array_equal(a, b)


def test_resize_matches_jax():
    img = np.random.default_rng(4).random((23, 31, 3)).astype(np.float32)
    for hw in ((11, 15), (46, 62)):
        assert np.array_equal(tloaders._resize(img, *hw), jloaders._resize(img, *hw))


# ---------------------------------------------------------------- matcher


def test_matcher_without_cv2_returns_zero_packs(monkeypatch):
    scene = _scene(6)
    monkeypatch.setattr(tmatching, "_HAS_CV2", False)
    monkeypatch.setattr(jmatching, "_HAS_CV2", False)
    t = tmatching.build_match_packs(scene.images, scene.masks, np.arange(3), scene.pair_j, max_matcher=32,
                                    backend="classical")
    j = jmatching.build_match_packs(scene.images, scene.masks, np.arange(3), scene.pair_j, max_matcher=32,
                                    backend="classical")
    for a, b in zip(j, t):
        assert b.shape == (3, 32, 5) and not b.any() and np.array_equal(a, b)


def test_matcher_backends(monkeypatch, tmp_path):
    scene = _scene(6)
    args = (scene.images[1], scene.images[0], None, 32)
    monkeypatch.delenv(tmatching.SUPERGLUE_WEIGHTS_ENV, raising=False)
    assert not tmatching.superglue_available()
    pack = tmatching.match_pair(*args, backend="auto")
    assert np.array_equal(pack, jmatching.match_pair(*args, backend="auto")) and pack[:, 4].any()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tmatching.match_pair(*args, backend="superglue")
    # weights named but absent: the reference matches classically, and so does the port
    monkeypatch.setenv(tmatching.SUPERGLUE_WEIGHTS_ENV, str(tmp_path / "missing.npz"))
    assert np.array_equal(tmatching.match_pair(*args, backend="auto"), pack)
    # weights present: the reference would run SuperGlue, which the port refuses to stand in for
    (tmp_path / "w.npz").write_bytes(b"")
    monkeypatch.setenv(tmatching.SUPERGLUE_WEIGHTS_ENV, str(tmp_path / "w.npz"))
    assert tmatching.superglue_available() and jmatching.superglue_available()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tmatching.match_pair(*args, backend="auto")
    assert np.array_equal(tmatching.match_pair(*args, backend="classical"), pack)


# ---------------------------------------------------------------- config and presets


def _preset_calls():
    from poseprobe_tpu.config.presets import dtu_scan, nerf_synthetic, replica_scene, toy_scene
    calls = [(name, {}) for name in PRESETS]
    calls += [("dtu_generic", dict(datadir="/d/DTU/scan7", scan_id=7, selected_id=(1, 2, 3)))]
    calls += [("dtu_scan", dict(scan_id=s)) for s in dtu_scan.SCAN_TABLE]
    calls += [("nerf_synthetic", dict(scene=s)) for s in nerf_synthetic.SCENE_TABLE]
    calls += [("replica_scene", dict(scene=s)) for s in replica_scene.SCENE_TABLE]
    calls += [("toy_scene", dict(scene=s, datadir="/d/toy")) for s in toy_scene.SCENES]
    return calls


def test_presets_match_the_reference():
    calls = _preset_calls()
    for name, kw in calls:
        j = importlib.import_module(f"poseprobe_tpu.config.presets.{name}").get_config(**kw)
        t = importlib.import_module(f"poseprobe_tpu_torch.config.presets.{name}").get_config(**kw)
        assert isinstance(t, tcfg.ExperimentConfig)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), (name, kw)
    for fam in ("dtu_scan", "nerf_synthetic", "replica_scene", "toy_scene"):
        j = importlib.import_module(f"poseprobe_tpu.config.presets.{fam}")
        t = importlib.import_module(f"poseprobe_tpu_torch.config.presets.{fam}")
        table = "SCAN_TABLE" if fam == "dtu_scan" else "SCENES" if fam == "toy_scene" else "SCENE_TABLE"
        assert getattr(t, table) == getattr(j, table)
        with pytest.raises(KeyError):
            t.get_config(123 if fam == "dtu_scan" else "nope")
    assert len(calls) > 30


def test_config_defaults_and_helpers():
    for name in ("DataConfig", "CameraConfig", "PnPConfig", "ObjectTrainConfig", "SceneTrainConfig",
                 "ExperimentConfig"):
        assert dataclasses.asdict(getattr(tcfg, name)()) == dataclasses.asdict(getattr(jcfg, name)()), name
    for dt in ("dtu", "llff", "blender"):
        for n in (2, 3, 6, 9):
            assert tcfg.max_iter_for(dt, n) == jcfg.max_iter_for(dt, n)
    cfg = tcfg.replace(tcfg.ExperimentConfig(), seed=5, expname="x")
    assert (cfg.seed, cfg.expname) == (5, "x")


# ---------------------------------------------------------------- every preset trains on the CPU


def small_widths(cfg):
    """A preset cut to CPU test widths; every option it sets stays."""
    return dataclasses.replace(
        cfg,
        object_model=dataclasses.replace(cfg.object_model, num_voxels=12 ** 3, num_voxels_base=12 ** 3),
        object_train=dataclasses.replace(cfg.object_train, N_rand=32),
        scene_model=dataclasses.replace(cfg.scene_model, layers_feat=(32,) * 4, layers_rgb=(16, 3), skip=(2,),
                                        L_3D=4, L_view=2, sample_intvs=8, sample_intvs_fine=8, rand_rays=64,
                                        matmul_dtype="float32"))


@pytest.mark.parametrize("name", PRESETS)
def test_joint_trainer_builds_and_steps_from_every_preset(name, tmp_path):
    from poseprobe_tpu_torch.train.trainer import JointTrainer
    cfg = importlib.import_module(f"poseprobe_tpu_torch.config.presets.{name}").get_config()
    fields = write_fixture(cfg.data.dataset_type, str(tmp_path))
    cfg = small_widths(dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, **fields)))
    data = tloaders.load_data(cfg.data, matcher_backend="classical")
    tr = JointTrainer(cfg, data, device="cpu")
    assert (tr.feature_maps is not None) == (cfg.object_train.weight_surface_projection > 0)
    m = tr.step()
    assert all(np.isfinite(v.item()) for v in m.values()), (name, m)
    flags = tr.phase_flags(0)
    assert ("feat_loss" in m) == tr._feature_term_on(flags)
    if name == "dtu_generic":
        assert "feat_loss" in m and m["feat_rays"].item() > 0
