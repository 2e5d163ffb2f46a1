"""Write a scene as a DTU scan on disk, in the IDR layout that
`poseprobe_tpu_torch.data.loaders.load_dtu` reads, with the port's PNG
writer (`poseprobe_tpu_torch/data/png.py`; no imageio needed). `chip_smoke.py`
and the port's tests write their DTU fixtures with it.

    from tools.dtu_fixture import write_dtu
    write_dtu(".../DTU/scan_x", scene)      # masks go to .../idrmasks/scan_x
"""
from __future__ import annotations

import os

import numpy as np

from poseprobe_tpu_torch.data.png import write_png


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
