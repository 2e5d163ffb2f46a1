"""Host-side feature matching for pose initialisation.

Port of `poseprobe_tpu/pose_init/matching.py`: at data-load time, produce
padded match packs ``[max_matcher, 5]`` = (x_j, y_j, x_i, y_i, conf) between
each training view i and its paired view j, in object-masked and full-image
variants. The classical backend (cv2 SIFT, else ORB, with mutual-ratio
matching) is the reference's, and without cv2 it returns zero packs as the
reference does. The SuperGlue backend is not ported: where the reference
would pick it, `match_pair` raises.
"""
from __future__ import annotations

import os

import numpy as np

try:
    import cv2
    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False

SUPERGLUE_WEIGHTS_ENV = "POSEPROBE_SUPERGLUE_WEIGHTS"


def _grayscale_u8(img: np.ndarray) -> np.ndarray:
    if img.ndim == 3:
        img = img[..., :3] @ np.array([0.299, 0.587, 0.114])
    return np.clip(img * 255.0, 0, 255).astype(np.uint8)


def match_pair_classical(img_i: np.ndarray, img_j: np.ndarray,
                         mask_j: np.ndarray | None,
                         max_matcher: int = 256,
                         ratio: float = 0.8) -> np.ndarray:
    """SIFT (fallback ORB) + mutual Lowe-ratio matching.

    Returns [max_matcher, 5]: (x_j, y_j, x_i, y_i, conf), zero-padded —
    the exact pack layout of `matching_pair` (`utils_vis.py:397-401`).
    """
    pack = np.zeros((max_matcher, 5), np.float32)
    if not _HAS_CV2:
        return pack
    g_i, g_j = _grayscale_u8(img_i), _grayscale_u8(img_j)
    # Small-image handling: SIFT's default octave pyramid finds few keypoints
    # on 64-300 px images, so detect on a cubic-upscaled copy with a
    # permissive contrast threshold and divide the coordinates back.
    up = max(1, int(round(256.0 / max(min(g_i.shape[:2] + g_j.shape[:2]), 1))))
    up = min(up, 4)
    if up > 1:
        g_i = cv2.resize(g_i, None, fx=up, fy=up, interpolation=cv2.INTER_CUBIC)
        g_j = cv2.resize(g_j, None, fx=up, fy=up, interpolation=cv2.INTER_CUBIC)
    det = None
    try:
        det = cv2.SIFT_create(nfeatures=4096, contrastThreshold=0.004,
                              edgeThreshold=16)
        norm = cv2.NORM_L2
    except Exception:
        det = cv2.ORB_create(nfeatures=4096)
        norm = cv2.NORM_HAMMING
    mask_u8 = None
    if mask_j is not None:
        mask_u8 = (np.asarray(mask_j).squeeze() > 0).astype(np.uint8) * 255
        if up > 1:
            mask_u8 = cv2.resize(mask_u8, None, fx=up, fy=up,
                                 interpolation=cv2.INTER_NEAREST)
    kp_j, des_j = det.detectAndCompute(g_j, mask_u8)
    kp_i, des_i = det.detectAndCompute(g_i, None)
    if des_j is None or des_i is None or len(kp_j) < 2 or len(kp_i) < 2:
        return pack
    matcher = cv2.BFMatcher(norm)
    knn = matcher.knnMatch(des_j, des_i, k=2)
    good = []
    for pair in knn:
        if len(pair) == 2 and pair[0].distance < ratio * pair[1].distance:
            good.append(pair[0])
    # mutual check
    knn_back = matcher.knnMatch(des_i, des_j, k=1)
    back = {m[0].queryIdx: m[0].trainIdx for m in knn_back if m}
    good = [m for m in good if back.get(m.trainIdx, -1) == m.queryIdx]
    good.sort(key=lambda m: m.distance)
    good = good[:max_matcher]
    # cv2.resize maps pixel CENTERS as x_up = up*x + (up-1)/2, so mapping
    # back must be (x_up + 0.5)/up - 0.5; plain x_up/up carries a constant
    # +(up-1)/(2*up) px bias into every anchor.
    def down(pt):
        return (np.asarray(pt) + 0.5) / up - 0.5
    for k, m in enumerate(good):
        pack[k, 0:2] = down(kp_j[m.queryIdx].pt)
        pack[k, 2:4] = down(kp_i[m.trainIdx].pt)
        pack[k, 4] = 1.0 / (1.0 + m.distance / 100.0)
    return pack


def superglue_available() -> bool:
    path = os.environ.get(SUPERGLUE_WEIGHTS_ENV, "")
    return bool(path) and os.path.exists(path)


def match_pair(img_i: np.ndarray, img_j: np.ndarray, mask_j: np.ndarray | None,
               max_matcher: int = 256, backend: str = "auto") -> np.ndarray:
    """Dispatch to the matcher the reference picks: SuperGlue for
    ``backend="superglue"`` and for ``"auto"`` with its weights present,
    else the classical matcher. SuperGlue is not ported, so those two cases
    raise rather than match with another backend."""
    if backend == "superglue" or (backend == "auto" and superglue_available()):
        raise NotImplementedError(
            f"backend={backend!r} selects SuperGlue (${SUPERGLUE_WEIGHTS_ENV} set: "
            f"{superglue_available()}), which is not ported yet (ROADMAP.md, modules to port: "
            "matchers); use backend='classical'")
    return match_pair_classical(img_i, img_j, mask_j, max_matcher)


def build_match_packs(images: np.ndarray, masks: np.ndarray | None,
                      i_train: np.ndarray, pair_j: np.ndarray,
                      max_matcher: int = 256, backend: str = "auto"):
    """Object-masked + full-scene match packs for all train views.

    Mirrors `matching_batch` (`load_dtu.py:133-155`): the object variant
    matches images zeroed outside the mask; the scene variant matches raw
    images; packs are per-(i, pair_j[i]).
    """
    n = len(i_train)
    obj_packs = np.zeros((n, max_matcher, 5), np.float32)
    scene_packs = np.zeros((n, max_matcher, 5), np.float32)
    for a in range(n):
        i, j = i_train[a], i_train[pair_j[a]]
        img_i, img_j = images[i], images[j]
        if masks is not None:
            m_i, m_j = masks[i], masks[j]
            masked_i = img_i * (m_i > 0)
            masked_j = img_j * (m_j > 0)
            obj_packs[a] = match_pair(masked_i, masked_j, m_j, max_matcher, backend)
            scene_packs[a] = match_pair(img_i, img_j, None, max_matcher, backend)
        else:
            scene_packs[a] = match_pair(img_i, img_j, None, max_matcher, backend)
            obj_packs[a] = scene_packs[a]
    return obj_packs, scene_packs
