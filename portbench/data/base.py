"""Dataset container of the benchmark's scenes (numpy, host side): a frozen
copy of the port's `data/base.py`. Match packs are padded to [n_train, M, 5]
(x_prev, y_prev, x_cur, y_cur, conf); conf 0 marks padding. Semantic pixel
pools are padded with counts.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class SemanticSamplers:
    """Per-view pixel pools for the 20/30/50 background/boundary/object split,
    from Gaussian-blurred object masks: object = blurred mask ~ 1, background
    = ~0, boundary = in between.
    pixels: [n_views, 3, max_pix, 2] int32 (x, y); counts: [n_views, 3].
    Class order: (background, boundary, object).
    """

    pixels: np.ndarray
    counts: np.ndarray


@dataclasses.dataclass
class SceneData:
    images: np.ndarray            # [n_views, H, W, 3] float32 in [0, 1]
    masks: np.ndarray             # [n_views, H, W, 1] float32 object masks
    Ks: np.ndarray                # [n_views, 3, 3]
    poses_gt_w2c: np.ndarray      # [n_views, 3, 4]
    i_train: np.ndarray           # [n_train] view indices
    i_test: np.ndarray            # [n_test]
    near: float
    far: float
    xyz_min: np.ndarray           # [3] object probe bbox
    xyz_max: np.ndarray
    # match packs, aligned with i_train order; pair_j[i] is the paired view
    obj_matches: Optional[np.ndarray] = None    # [n_train, M, 5] object-masked
    scene_matches: Optional[np.ndarray] = None  # [n_train, M, 5] full-image
    pair_j: Optional[np.ndarray] = None         # [n_train] int
    ba_matches: Optional[np.ndarray] = None     # [n_pairs, M, 5] (i-2, i) skip pairs
    ba_pairs: Optional[np.ndarray] = None       # [n_pairs, 2] int
    samplers: Optional[SemanticSamplers] = None
    scale_mats: Optional[np.ndarray] = None     # DTU world-scale mats for mesh eval
    depth_gt: Optional[np.ndarray] = None       # [n_views, H, W] camera-z
    inverse_y: bool = True
    flip_x: bool = False
    flip_y: bool = False
    white_bkgd: bool = False

    @property
    def n_train(self) -> int:
        return len(self.i_train)

    @property
    def H(self) -> int:
        return self.images.shape[1]

    @property
    def W(self) -> int:
        return self.images.shape[2]


def default_pair_j(n_train: int) -> np.ndarray:
    """Paired view for match packs: i-1 for i>0, 1 for i=0."""
    pj = np.maximum(np.arange(n_train) - 1, 0)
    if n_train > 1:
        pj[0] = 1
    return pj.astype(np.int32)


def build_semantic_samplers(masks: np.ndarray, blur_sigma: float = 5.0,
                            lo: float = 0.05, hi: float = 0.95) -> SemanticSamplers:
    """3-class pixel pools from Gaussian-blurred masks [n_views, H, W, 1]
    (host-side numpy/scipy preprocessing)."""
    from scipy.ndimage import gaussian_filter

    n = masks.shape[0]
    pools = []
    counts = np.zeros((n, 3), np.int32)
    for i in range(n):
        blurred = gaussian_filter(masks[i, :, :, 0].astype(np.float32), blur_sigma)
        bg = np.argwhere(blurred <= lo)
        bd = np.argwhere((blurred > lo) & (blurred < hi))
        ob = np.argwhere(blurred >= hi)
        pools.append((bg, bd, ob))
        counts[i] = [max(len(bg), 1), max(len(bd), 1), max(len(ob), 1)]
    max_pix = max(max(max(len(p) for p in view) for view in pools), 1)
    pixels = np.zeros((n, 3, max_pix, 2), np.int32)
    for i, view in enumerate(pools):
        for c, p in enumerate(view):
            # argwhere gives (y, x); stored as (x, y)
            pixels[i, c, : len(p), 0] = p[:, 1]
            pixels[i, c, : len(p), 1] = p[:, 0]
    return SemanticSamplers(pixels=pixels, counts=counts)
