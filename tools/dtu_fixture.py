"""Write a scene as a DTU scan on disk, in the IDR layout that
`poseprobe_tpu_torch.data.loaders.load_dtu` reads, with a PNG encoder on
zlib and numpy (no imageio needed). `chip_smoke.py` and the port's tests
write their DTU fixtures with it.

    from tools.dtu_fixture import write_dtu
    write_dtu(".../DTU/scan_x", scene)      # masks go to .../idrmasks/scan_x
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOUR_TYPE = {1: 0, 3: 2, 2: 4, 4: 6}     # channels -> colour type


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, level: int = 1) -> bytes:
    """A PNG of uint8 or uint16 pixels, [H, W] or [H, W, C] with C in 1-4,
    every row with filter None."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"PNG pixels are uint8 or uint16, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    depth = 8 * img.dtype.itemsize
    body = img.astype(">u2").view(np.uint8) if depth == 16 else img
    rows = np.concatenate([np.zeros((H, 1), np.uint8), body.reshape(H, -1)], axis=1)
    header = struct.pack(">IIBBBBB", W, H, depth, _COLOUR_TYPE[C], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray, level: int = 1) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img, level))


def write_dtu(datadir: str, data) -> None:
    """Write every view of `data` (a `SceneData`) in the DTU (IDR) layout:
    image/%06d.png, the masks under the path with "DTU" replaced by
    "idrmasks", and cameras.npz with world_mat_i = K [R | t] and an identity
    scale_mat_i."""
    mask_dir = os.path.join(datadir.replace("DTU", "idrmasks"), "mask")
    os.makedirs(os.path.join(datadir, "image"), exist_ok=True)
    os.makedirs(mask_dir, exist_ok=True)
    cams = {}
    for i in range(len(data.images)):
        world = np.eye(4)
        world[:3, :4] = data.Ks[i].astype(np.float64) @ data.poses_gt_w2c[i]
        cams[f"world_mat_{i}"] = world.astype(np.float32)
        cams[f"scale_mat_{i}"] = np.eye(4, dtype=np.float32)
        write_png(os.path.join(datadir, "image", f"{i:06d}.png"),
                  np.round(np.clip(data.images[i], 0, 1) * 255).astype(np.uint8))
        write_png(os.path.join(mask_dir, f"{i:06d}.png"),
                  np.round(np.clip(data.masks[i][..., 0], 0, 1) * 255).astype(np.uint8))
    np.savez(os.path.join(datadir, "cameras.npz"), **cams)
