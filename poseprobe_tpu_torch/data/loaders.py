"""Dataset loaders: DTU, Blender (NeRF-synthetic), Toy, Custom, Replica and
ShapeNet-in-scene.

Port of `poseprobe_tpu/data/loaders.py`: the `load_data` dispatcher and the
per-format loaders on top of the `SceneData` container. Feature matching runs
at load time through `pose_init.matching` (SuperGlue's networks on
`matcher_device`, the card unless the caller passes another). Images are read
by `data/png.py`: PNGs without imageio, other formats through imageio or PIL.

All loaders are host-side numpy; they only shape data for the trainer.
"""
from __future__ import annotations

import json
import os
from glob import glob

import numpy as np

from ..config.config import DataConfig
from ..pose_init import matching as matching_mod
from . import base
from .png import imread


# ---------------------------------------------------------------- common bits

def load_K_Rt_from_P(P: np.ndarray):
    """Decompose a 3x4 projection into intrinsics + c2w pose (IDR convention,
    `load_dtu.py:15-36`). Numpy RQ decomposition; no OpenCV needed."""
    M = P[:3, :3]
    # RQ decomposition via flipped QR
    rev = np.flipud(np.eye(3))
    q, r = np.linalg.qr((rev @ M).T)
    K = rev @ r.T @ rev
    R = rev @ q.T
    # enforce positive diagonal of K
    sign = np.diag(np.sign(np.diag(K)))
    K = K @ sign
    R = sign @ R
    if np.linalg.det(R) < 0:
        K, R = -K, -R
    t = np.linalg.solve(K, P[:3, 3])
    K = K / K[2, 2]
    pose_c2w = np.eye(4, dtype=np.float32)
    pose_c2w[:3, :3] = R.T
    pose_c2w[:3, 3] = -R.T @ t
    intr = np.eye(3, dtype=np.float32)
    intr[:] = K
    return intr, pose_c2w


def _imread_float(path: str) -> np.ndarray:
    return (np.asarray(imread(path)) / 255.0).astype(np.float32)


def _resize(img: np.ndarray, H: int, W: int) -> np.ndarray:
    try:
        import cv2
        return cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA)
    except Exception:
        from scipy.ndimage import zoom
        zy, zx = H / img.shape[0], W / img.shape[1]
        factors = (zy, zx) + (1,) * (img.ndim - 2)
        return zoom(img, factors, order=1)


def _finalize(cfg: DataConfig, images, masks, Ks, poses_w2c, i_train, i_test,
              scale_mats=None, matcher_backend: str = "auto", matcher_device="cuda",
              depth_gt=None) -> base.SceneData:
    """Match packs + semantic samplers + container assembly (shared tail)."""
    images = np.asarray(images, np.float32)
    if images.shape[-1] == 4:  # RGBA -> composite over white/black
        rgb, a = images[..., :3], images[..., 3:]
        bg = 1.0 if cfg.white_bkgd else 0.0
        images = rgb * a + bg * (1 - a)
    masks = np.asarray(masks, np.float32)
    if masks.ndim == 3:
        masks = masks[..., None]
    pair_j = base.default_pair_j(len(i_train))
    obj_m, scene_m = matching_mod.build_match_packs(
        images, masks, np.asarray(i_train), pair_j,
        max_matcher=cfg.max_matcher, backend=matcher_backend, device=matcher_device)
    # skip-pair packs for the match-BA pose polish (pose_init/ba.py)
    it = np.asarray(i_train)
    ba_pairs = np.array([[a - 2, a] for a in range(2, len(it))], np.int32) \
        if len(it) >= 3 else np.zeros((0, 2), np.int32)
    ba_m = np.stack([matching_mod.match_pair(images[it[b]], images[it[a]], None,
                                             cfg.max_matcher, matcher_backend, matcher_device)
                     for a, b in ba_pairs]) if len(ba_pairs) else \
        np.zeros((0, cfg.max_matcher, 5), np.float32)
    samplers = base.build_semantic_samplers(masks[np.asarray(i_train)])
    return base.SceneData(
        images=images, masks=masks, Ks=np.asarray(Ks, np.float32),
        poses_gt_w2c=np.asarray(poses_w2c, np.float32),
        i_train=np.asarray(i_train), i_test=np.asarray(i_test),
        near=cfg.near, far=cfg.far,
        xyz_min=np.asarray(cfg.xyz_min, np.float32),
        xyz_max=np.asarray(cfg.xyz_max, np.float32),
        obj_matches=obj_m, scene_matches=scene_m, pair_j=pair_j,
        ba_matches=ba_m, ba_pairs=ba_pairs,
        samplers=samplers, scale_mats=scale_mats,
        depth_gt=None if depth_gt is None else np.asarray(depth_gt, np.float32),
        inverse_y=cfg.inverse_y, flip_x=cfg.flip_x, flip_y=cfg.flip_y,
        white_bkgd=cfg.white_bkgd,
    )


# ----------------------------------------------------------------------- DTU

DTU_EXCLUDE_TEST = (3, 4, 5, 6, 7, 16, 17, 18, 19, 20, 21, 36, 37, 38, 39)


def load_dtu(cfg: DataConfig, reso_level: int = 1, matcher_backend: str = "auto",
             matcher_device="cuda") -> base.SceneData:
    """DTU (IDR layout): image/*.png + cameras.npz + idrmasks
    (`load_dtu.py:40-172`). Train views = cfg.selected_id; test = the
    remaining 49 minus the standard exclude list."""
    basedir = cfg.datadir
    rgb_paths = sorted(glob(os.path.join(basedir, "image", "*png"))) or \
        sorted(glob(os.path.join(basedir, "image", "*jpg"))) or \
        sorted(glob(os.path.join(basedir, "rgb", "*png")))
    mask_dir = basedir.replace("DTU", "idrmasks")
    mask_paths = sorted(glob(os.path.join(mask_dir, "mask", "*png"))) or \
        sorted(glob(os.path.join(mask_dir, "mask", "*jpg")))
    cam = np.load(os.path.join(basedir, "cameras.npz"))
    n_all = len(rgb_paths)

    i_train = list(cfg.selected_id)
    i_test = [i for i in range(min(49, n_all)) if i not in i_train + list(DTU_EXCLUDE_TEST)]
    order = i_train + i_test

    images, masks, Ks, poses = [], [], [], []
    scale_mats = cam[f"scale_mat_{order[0]}"].astype(np.float32)
    for i in order:
        P = (cam[f"world_mat_{i}"].astype(np.float32) @ cam[f"scale_mat_{i}"].astype(np.float32))[:3, :4]
        K, pose_c2w = load_K_Rt_from_P(P)
        poses.append(np.linalg.inv(pose_c2w)[:3, :])
        img = _imread_float(rgb_paths[i])[..., :3]
        m = _imread_float(mask_paths[i]) if mask_paths else np.ones(img.shape[:2], np.float32)
        if m.ndim == 3:
            m = m[..., 0]
        if m.shape != img.shape[:2]:
            m = _resize(m, img.shape[0], img.shape[1])
        if reso_level > 1:
            H, W = img.shape[0] // reso_level, img.shape[1] // reso_level
            img = _resize(img, H, W)
            m = _resize(m, H, W)
            K = K.copy()
            K[:2] /= reso_level
        images.append(img)
        masks.append(m)
        Ks.append(K)
    new_train = list(range(len(i_train)))
    new_test = list(range(len(i_train), len(order)))
    return _finalize(cfg, np.stack(images), np.stack(masks), np.stack(Ks),
                     np.stack(poses), new_train, new_test, scale_mats, matcher_backend,
                     matcher_device)


# ------------------------------------------------------------------- Blender

def _parse_raw_camera_blender(c2w_blender: np.ndarray) -> np.ndarray:
    """Blender (right, up, backward) c2w -> OpenCV w2c [3, 4]
    (`load_blender.py:136-140`)."""
    flip = np.diag([1.0, -1.0, -1.0])
    R = c2w_blender[:3, :3] @ flip
    t = c2w_blender[:3, 3]
    # w2c = invert([R|t])
    return np.concatenate([R.T, (-R.T @ t)[:, None]], axis=1).astype(np.float32)


def load_blender(cfg: DataConfig, half_res: bool = False, matcher_backend: str = "auto",
                 matcher_device="cuda") -> base.SceneData:
    """NeRF-synthetic transforms_{train,val,test}.json (`load_blender.py:142-270`)."""
    basedir = cfg.datadir
    images, poses = [], []
    counts = [0]
    for s in ("train", "val", "test"):
        with open(os.path.join(basedir, f"transforms_{s}.json")) as fp:
            meta = json.load(fp)
        skip = cfg.trainskip if s == "train" else cfg.testskip
        frames = meta["frames"][::max(skip, 1)]
        for frame in frames:
            img = _imread_float(os.path.join(basedir, frame["file_path"] + ".png"))
            images.append(img)
            poses.append(_parse_raw_camera_blender(np.asarray(frame["transform_matrix"], np.float32)))
        counts.append(counts[-1] + len(frames))
    images = np.stack(images)
    masks = images[..., 3] if images.shape[-1] == 4 else np.ones(images.shape[:3], np.float32)
    H, W = images.shape[1:3]
    focal = 0.5 * W / np.tan(0.5 * float(meta["camera_angle_x"]))
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float32)
    if half_res:
        H2, W2 = H // 2, W // 2
        images = np.stack([_resize(im, H2, W2) for im in images])
        masks = np.stack([_resize(m, H2, W2) for m in masks])
        K = K.copy()
        K[:2] /= 2
    if cfg.selected_id is not None:
        i_train = list(cfg.selected_id)
    else:
        i_train = list(range(counts[0], counts[1]))
    i_test = list(range(counts[2], counts[3]))
    Ks = np.tile(K[None], (len(images), 1, 1))
    return _finalize(cfg, images, masks, Ks, np.stack(poses), i_train, i_test,
                     matcher_backend=matcher_backend, matcher_device=matcher_device)


# ----------------------------------------------------------------------- Toy

def load_toy(cfg: DataConfig, pose_scale: float = 5.0, inst_seg_tag: int = 1,
             matcher_backend: str = "auto", matcher_device="cuda") -> base.SceneData:
    """Toy-desk scenes: transforms json + *.instance.png masks
    (`load_toy.py:142-258`). Poses are OpenCV c2w scaled by `pose_scale`."""
    basedir = cfg.datadir
    images, masks, poses = [], [], []
    counts = [0]
    for s in ("train", "val", "test"):
        with open(os.path.join(basedir, f"transforms_{s}.json")) as fp:
            meta = json.load(fp)
        frames = meta["frames"]
        for frame in frames:
            fname = os.path.join(basedir, frame["file_path"] + ".png")
            img = _imread_float(fname)
            images.append(img[..., :3])
            inst = np.asarray(imread(fname.replace(".png", ".instance.png")))
            masks.append((inst == inst_seg_tag).astype(np.float32))
            c2w = np.asarray(frame["transform_matrix"], np.float32)
            c2w[:, 3] /= pose_scale
            R, t = c2w[:3, :3], c2w[:3, 3]
            poses.append(np.concatenate([R.T, (-R.T @ t)[:, None]], 1))
        counts.append(counts[-1] + len(frames))
    images = np.stack(images)
    masks = np.stack(masks)
    H, W = images.shape[1:3]
    focal = 0.5 * W / np.tan(0.5 * float(meta["camera_angle_x"]))
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float32)
    i_train = list(cfg.selected_id)
    i_test = list(cfg.test_id) if cfg.test_id is not None else list(range(counts[2], counts[3]))
    Ks = np.tile(K[None], (len(images), 1, 1))
    return _finalize(cfg, images, masks, Ks, np.stack(poses, 0).astype(np.float32),
                     i_train, i_test, matcher_backend=matcher_backend, matcher_device=matcher_device)


# -------------------------------------------------------------------- Custom

def load_custom(cfg: DataConfig, matcher_backend: str = "auto", matcher_device="cuda") -> base.SceneData:
    """Custom captures: scene_image/%05d.jpg + scene_mask + w2c.npy +
    intrinsics.txt (`load_custom.py:184-260`)."""
    basedir = cfg.datadir
    pose_w2c = np.load(os.path.join(basedir, "w2c.npy")).astype(np.float32)
    sel = list(cfg.selected_id)
    all_ids = list(range(0, max(sel) + 1))
    images, masks, poses = [], [], []
    for frame in all_ids:
        fname = os.path.join(basedir, "scene_image", f"{frame:05d}.jpg")
        images.append(_imread_float(fname)[..., :3])
        mpath = fname.replace("_image", "_mask")
        m = np.asarray(imread(mpath)) if os.path.exists(mpath) else None
        masks.append((m > 0).astype(np.float32) if m is not None
                     else np.ones(images[-1].shape[:2], np.float32))
        poses.append(pose_w2c[frame][:3, :4])
    intr = np.loadtxt(os.path.join(basedir, "intrinsics.txt")).astype(np.float32)
    K = intr[:3, :3]
    i_train = sel
    i_test = [i for i in all_ids if i not in sel]
    images = np.stack(images)
    masks = np.stack(masks)
    if masks.ndim == 4:
        masks = masks[..., 0]
    Ks = np.tile(K[None], (len(images), 1, 1))
    return _finalize(cfg, images, masks, Ks, np.stack(poses), i_train, i_test,
                     matcher_backend=matcher_backend, matcher_device=matcher_device)


# ------------------------------------------------------------------- Replica

def load_replica(cfg: DataConfig, png_depth_scale: float = 6553.5,
                 matcher_backend: str = "auto", matcher_device="cuda") -> base.SceneData:
    """Replica sequences: results/frame*.jpg + depth*.png + traj.txt c2w
    (`load_replica.py`). Object masks fall back to depth>0 (`:395`)."""
    basedir = cfg.datadir
    color_paths = sorted(glob(os.path.join(basedir, "results", "frame*.jpg")))
    depth_paths = sorted(glob(os.path.join(basedir, "results", "depth*.png")))
    traj = np.loadtxt(os.path.join(basedir, "traj.txt")).reshape(-1, 4, 4).astype(np.float32)
    sel = list(cfg.selected_id)
    test = list(cfg.test_id) if cfg.test_id is not None else \
        [i for i in range(len(color_paths)) if i not in sel][:: max(cfg.testskip, 1)]
    order = sel + test
    images, masks, poses, depths = [], [], [], []
    for i in order:
        img = _imread_float(color_paths[i])[..., :3]
        depth = np.asarray(imread(depth_paths[i])).astype(np.float32) / png_depth_scale
        if depth.shape != img.shape[:2]:
            img = _resize(img, depth.shape[0], depth.shape[1])
        images.append(img)
        masks.append((depth > 0).astype(np.float32))
        depths.append(depth)  # camera-z GT, 0 = invalid (load_replica.py:395)
        c2w = traj[i]
        R, t = c2w[:3, :3], c2w[:3, 3]
        poses.append(np.concatenate([R.T, (-R.T @ t)[:, None]], 1))
    H, W = images[0].shape[:2]
    # replica cam intrinsics (standard): fx = fy = W / (2 * tan(fov/2)), fov 90deg
    fx = W / 2.0
    K = np.array([[fx, 0, (W - 1) / 2], [0, fx, (H - 1) / 2], [0, 0, 1]], np.float32)
    Ks = np.tile(K[None], (len(images), 1, 1))
    i_train = list(range(len(sel)))
    i_test = list(range(len(sel), len(order)))
    return _finalize(cfg, np.stack(images), np.stack(masks), Ks,
                     np.stack(poses), i_train, i_test, matcher_backend=matcher_backend,
                     matcher_device=matcher_device, depth_gt=np.stack(depths))


# ------------------------------------------------------- scene_with_shapenet

def load_scene_with_shapenet(cfg: DataConfig, object_center=(0.0, 0.0, 0.0),
                             matcher_backend: str = "auto", matcher_device="cuda") -> base.SceneData:
    """ShapeNet-probe scenes: blender transforms json, `colors` images with
    sibling `mask` files, blender c2w shifted by the probe object center
    (`load_scene_with_shapenet.py:188-242`)."""
    basedir = cfg.datadir
    images, masks, poses = [], [], []
    counts = [0]
    center = np.asarray(object_center, np.float32)
    for s in ("train", "val", "test"):
        with open(os.path.join(basedir, f"transforms_{s}.json")) as fp:
            meta = json.load(fp)
        frames = meta["frames"]
        for frame in frames:
            fname = os.path.join(basedir, frame["file_path"] + ".png")
            images.append(_imread_float(fname)[..., :3])
            m = _imread_float(fname.replace("colors", "mask"))
            masks.append(m[..., 0] if m.ndim == 3 else m)
            c2w = np.asarray(frame["transform_matrix"], np.float32)
            c2w[:3, 3] -= center
            poses.append(_parse_raw_camera_blender(c2w))
        counts.append(counts[-1] + len(frames))
    images = np.stack(images)
    masks = np.stack(masks)
    H, W = images.shape[1:3]
    focal = 0.5 * W / np.tan(0.5 * float(meta["camera_angle_x"]))
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float32)
    i_train = list(cfg.selected_id)
    i_test = list(cfg.test_id) if cfg.test_id is not None else list(range(counts[2], counts[3]))
    Ks = np.tile(K[None], (len(images), 1, 1))
    return _finalize(cfg, images, masks, Ks, np.stack(poses), i_train, i_test,
                     matcher_backend=matcher_backend, matcher_device=matcher_device)


# ---------------------------------------------------------------- dispatcher

def load_data(cfg: DataConfig, matcher_backend: str = "auto", matcher_device="cuda",
              **kwargs) -> base.SceneData:
    """`lib/load_data.py:11-129` analog keyed on dataset_type."""
    if cfg.dataset_type == "dtu":
        return load_dtu(cfg, matcher_backend=matcher_backend, matcher_device=matcher_device, **kwargs)
    if cfg.dataset_type == "blender":
        return load_blender(cfg, matcher_backend=matcher_backend, matcher_device=matcher_device, **kwargs)
    if cfg.dataset_type == "toy":
        return load_toy(cfg, matcher_backend=matcher_backend, matcher_device=matcher_device, **kwargs)
    if cfg.dataset_type == "custom":
        return load_custom(cfg, matcher_backend=matcher_backend, matcher_device=matcher_device, **kwargs)
    if cfg.dataset_type == "replica":
        return load_replica(cfg, matcher_backend=matcher_backend, matcher_device=matcher_device, **kwargs)
    if cfg.dataset_type == "scene_with_shapenet":
        return load_scene_with_shapenet(cfg, matcher_backend=matcher_backend, matcher_device=matcher_device, **kwargs)
    if cfg.dataset_type == "synthetic":
        from .synthetic import make_synthetic_scene
        return make_synthetic_scene(matcher_device=matcher_device, **kwargs)
    raise ValueError(f"unknown dataset_type: {cfg.dataset_type}")
