"""The port's SuperPoint + SuperGlue matcher (`pose_init/superglue.py`) and its
weight converter (`pose_init/convert.py`), held stage by stage against
`poseprobe_tpu/pose_init/superglue.py` on seeded random weights written under
the published state_dict keys (`tools/superglue_weights.py`); no pretrained
weights exist here.

The JAX forwards are single functions, so their stages are read by wrapping
the JAX primitives they call (`reduce_window`'s first input is the heat map
before NMS, `top_k`'s input and output the ranking, `bilinear_image_sample`'s
input the descriptor map, `_log_sinkhorn`'s output the log assignment) and
fed by replacing one (`softmax` hands NMS a given heat map, `top_k` gives
keypoints).

Tolerances: the SuperPoint maps within 1e-4 of max |JAX| (float32 convs in
another order); NMS and top-K on one given heat map exact, ties included; the
descriptors at given keypoints within 1e-6 abs; the log assignment within
1e-4 abs, `matches0` equal, `mscores0` within 1e-5 rel; the `match_pair`
pack's keypoints and matches equal, its confidences within 1e-5 rel.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseprobe_tpu.core import geometry as jgeo
from poseprobe_tpu.pose_init import convert as jconvert, matching as jmatching, superglue as jsg
from poseprobe_tpu_torch.pose_init import convert as tconvert, matching as tmatching, superglue as tsg
from tools.superglue_weights import superglue_state, superpoint_state, write

torch.set_num_threads(1)

SP, SG = superpoint_state(0), superglue_state(1)


@pytest.fixture(scope="module")
def nets():
    return tsg._build(tsg.SuperPoint, SP, "cpu"), tsg._build(tsg.SuperGlue, SG, "cpu")


def _image(H=48, W=72, seed=0):
    """A smooth random image: value noise at two scales, in [0, 1]."""
    rng = np.random.default_rng(seed)
    coarse = rng.random((H // 8 + 2, W // 8 + 2))
    img = np.kron(coarse, np.ones((8, 8)))[:H, :W] * 0.6 + rng.random((H, W)) * 0.4
    return img.astype(np.float32)


class _Record:
    """Wrap `obj.name`: record the first call's positional args and result;
    `replace` (if given) computes the result instead."""

    def __init__(self, monkeypatch, obj, name, replace=None):
        self.args = self.out = None
        orig = getattr(obj, name)

        def wrapper(*a, **k):
            out = (replace or orig)(*a, **k)
            if self.args is None:
                self.args, self.out = a, out
            return out
        monkeypatch.setattr(obj, name, wrapper)


def _jax_superpoint(monkeypatch, img, **kw):
    heat = _Record(monkeypatch, jax.lax, "reduce_window")
    desc_map = _Record(monkeypatch, jgeo, "bilinear_image_sample")
    out = jsg.superpoint_forward(SP, jnp.asarray(img), **kw)
    monkeypatch.undo()
    return out, np.asarray(heat.args[0]), np.asarray(desc_map.args[0])


def test_the_modules_take_the_published_keys(nets):
    sp, sg = nets
    assert set(sp.state_dict()) == set(SP) and set(sg.state_dict()) == set(SG)
    assert len(SG) == 5 * 2 + 4 * 5 + 18 * (4 * 2 + 2 * 2 + 5) + 3 and SG["bin_score"].shape == ()
    assert not sg.training and not sg.kenc.encoder[1].training


def test_superpoint_maps_and_keypoints(nets, monkeypatch):
    sp, _ = nets
    img = _image()
    (jk, js, jd), jheat, jdesc_map = _jax_superpoint(monkeypatch, img, max_keypoints=64)
    with torch.no_grad():
        heat, desc_map = sp.maps(torch.tensor(img))
        assert heat.shape == jheat.shape == (48, 72) and desc_map.shape == jdesc_map.shape == (6, 9, 256)
        for ours, ref in ((heat, jheat), (desc_map, jdesc_map)):
            assert np.abs(ours.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
        # NMS and top-K on the JAX heat map: the same keypoints and scores, exactly
        k, s = tsg.nms_topk(torch.tensor(jheat), max_keypoints=64)
        assert np.array_equal(k.numpy(), np.asarray(jk)) and np.array_equal(s.numpy(), np.asarray(js))
        # the descriptors at those keypoints from the port's own map
        d = tsg.sample_descriptors(desc_map, k)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=1e-4)


def _heat_cases():
    rng = np.random.default_rng(3)
    sparse = np.zeros((40, 56), np.float32)            # 6 maxima: the other 58 of K = 64 tie at 0
    for y, x, v in ((10, 10, 0.5), (10, 30, 0.5), (20, 20, 0.3), (30, 44, 0.5), (5, 50, 0.9), (35, 6, 0.3)):
        sparse[y, x] = v
    plateau = np.zeros((40, 56), np.float32)            # equal neighbours, and a maximum on the border cut
    plateau[12, 12] = plateau[12, 13] = plateau[13, 12] = 0.4
    plateau[25:28, 30:33] = 0.2
    plateau[2, 20] = 0.8
    noisy = np.round(rng.random((40, 56)) * 8).astype(np.float32) / 8.0     # many exact ties
    # (heat, threshold, whether zero scores pad the K = 64 keypoints)
    return {"sparse": (sparse, 0.0, True), "plateau": (plateau, 0.0, True), "noisy_thresholded": (noisy, 0.5, False)}


@pytest.mark.parametrize("case", list(_heat_cases()))
def test_nms_and_topk_on_a_given_heat_map_exactly(case, monkeypatch):
    heat, thr, padded = _heat_cases()[case]
    h, w = heat.shape[0] // 8, heat.shape[1] // 8
    cells = heat.reshape(h, 8, w, 8).transpose(0, 2, 1, 3).reshape(h, w, 64)
    probs = jnp.asarray(np.concatenate([cells, np.zeros((h, w, 1), np.float32)], -1))
    _Record(monkeypatch, jax.nn, "softmax", replace=lambda x, axis=-1: probs)
    jk, js, _ = jsg.superpoint_forward(SP, jnp.zeros(heat.shape), keypoint_threshold=thr, max_keypoints=64)
    monkeypatch.undo()
    k, s = tsg.nms_topk(torch.tensor(heat), 2, thr, 64)
    assert np.array_equal(k.numpy(), np.asarray(jk)) and np.array_equal(s.numpy(), np.asarray(js))
    assert bool((s == 0).any()) == padded      # zero scores pad the set: their order is the tie order


def test_descriptor_sampling_at_given_keypoints(monkeypatch):
    img = _image(seed=1)
    rng = np.random.default_rng(4)
    idx = rng.choice(48 * 72, 32, replace=False)
    idx[:4] = [0, 71, 48 * 72 - 1, 47 * 72]          # the corners: the clamped border of the map
    given = (jnp.asarray(rng.random(32), jnp.float32), jnp.asarray(idx, jnp.int32))
    _Record(monkeypatch, jax.lax, "top_k", replace=lambda x, k: given)
    desc_map = _Record(monkeypatch, jgeo, "bilinear_image_sample")
    jk, _, jd = jsg.superpoint_forward(SP, jnp.asarray(img), max_keypoints=32)
    monkeypatch.undo()
    assert np.array_equal(np.asarray(jk), np.stack([idx % 72, idx // 72], -1).astype(np.float32))
    d = tsg.sample_descriptors(torch.tensor(np.asarray(desc_map.args[0])), torch.tensor(np.asarray(jk)))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=1e-6)


def _keypoint_sets(n0=40, n1=32, seed=5, HW=(120, 160)):
    """Two keypoint sets where set 1 repeats 24 of set 0 (moved by a pixel,
    descriptors perturbed), so that mutual matches exist."""
    rng = np.random.default_rng(seed)
    H, W = HW
    k0 = (rng.random((n0, 2)) * [W - 1, H - 1]).astype(np.float32)
    d0 = rng.normal(size=(n0, 256)).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    pick = rng.permutation(n0)[:24]
    k1 = np.concatenate([k0[pick] + 1.0, (rng.random((n1 - 24, 2)) * [W - 1, H - 1])]).astype(np.float32)
    d1 = np.concatenate([d0[pick] + rng.normal(0, 0.05, (24, 256)), rng.normal(size=(n1 - 24, 256))])
    d1 = (d1 / np.linalg.norm(d1, axis=-1, keepdims=True)).astype(np.float32)
    s0, s1 = rng.random(n0).astype(np.float32), rng.random(n1).astype(np.float32)
    return (k0, s0, d0, k1, s1, d1), HW


def test_superglue_at_given_keypoints(nets, monkeypatch):
    _, sg = nets
    sets, HW = _keypoint_sets()
    Z = _Record(monkeypatch, jsg, "_log_sinkhorn")
    jm, jms = jsg.superglue_forward(SG, *[jnp.asarray(a) for a in sets], HW, match_threshold=0.0)
    monkeypatch.undo()
    jZ, jm, jms = np.asarray(Z.out), np.asarray(jm), np.asarray(jms)
    with torch.no_grad():
        tZ = sg.log_assignment(*[torch.tensor(a) for a in sets], HW)
    assert tZ.shape == jZ.shape == (41, 33)
    np.testing.assert_allclose(tZ.numpy(), jZ, rtol=0, atol=1e-4)
    m, ms = tsg.mutual_matches(tZ, 0.0)
    assert np.array_equal(m.numpy(), jm) and (jm > -1).sum() >= 8
    np.testing.assert_allclose(ms.numpy(), jms, rtol=1e-5, atol=0)
    # the default threshold: the mutual matches above 0.2 (the JAX rule, from its own scores)
    m2, _ = tsg.mutual_matches(tZ, 0.2)
    assert np.array_equal(m2.numpy(), np.where((jm > -1) & (jms > 0.2), jm, -1)) and (m2 > -1).sum() >= 8


def test_match_pair_pack_on_a_seeded_pair(monkeypatch, tmp_path):
    write(str(tmp_path))
    monkeypatch.setenv(jmatching.SUPERGLUE_WEIGHTS_ENV, str(tmp_path))
    jsg._CACHE.clear()
    img_j = np.stack([_image(64, 80, seed=6)] * 3, -1)
    img_i = np.roll(img_j, 3, axis=1)
    mask_j = np.zeros((64, 80, 1), np.float32)
    mask_j[4:60, 4:66] = 1.0
    ref = jsg.match_pair_superglue(img_i, img_j, mask_j, max_matcher=128)
    pack = tsg.match_pair_superglue(img_i, img_j, mask_j, max_matcher=128, device="cpu")
    jsg._CACHE.clear()
    n = int((ref[:, 4] > 0).sum())
    # matches survive the published 0.2 threshold
    assert pack.shape == ref.shape == (128, 5) and n >= 8 and int((pack[:, 4] > 0).sum()) == n
    # the same matches; their order is by confidence, which agrees to float32 rounding.
    order_r, order_p = np.lexsort(ref[:n, :4].T), np.lexsort(pack[:n, :4].T)
    assert np.array_equal(pack[:n, :4][order_p], ref[:n, :4][order_r])
    np.testing.assert_allclose(pack[:n, 4][order_p], ref[:n, 4][order_r], rtol=1e-5)
    assert not pack[n:].any()


def test_weights_files_the_cache_and_the_convert_cli(monkeypatch, tmp_path):
    # .npz written by the port reads the same through both packages' loaders
    paths = write(str(tmp_path / "npz"))
    for stem, sd in (("superpoint_v1", SP), ("superglue_indoor", SG)):
        for loaded in (tconvert.load_npz(paths[stem]), jconvert.load_npz(paths[stem])):
            assert set(loaded) == set(sd) and all(np.array_equal(loaded[k], sd[k]) for k in sd)
    # a .pth (a state_dict, and one wrapped under "state_dict") through the CLI, both modes
    pth = tmp_path / "pth"
    pth.mkdir()
    sd = {k: torch.as_tensor(v) for k, v in SP.items()}
    torch.save(sd, pth / "superpoint_v1.pth")
    torch.save({"state_dict": {k: torch.as_tensor(v) for k, v in SG.items()}}, pth / "superglue_indoor.pth")
    assert tconvert.main(["--pth", str(pth / "superpoint_v1.pth"), "--out", str(tmp_path / "one.npz")]) == 0
    assert all(np.array_equal(tconvert.load_npz(str(tmp_path / "one.npz"))[k], SP[k]) for k in SP)
    assert tconvert.main(["--pth-dir", str(pth), "--out-dir", str(tmp_path / "conv")]) == 0
    got = tconvert.load_npz(str(tmp_path / "conv" / "superglue_indoor.npz"))
    assert set(got) == set(SG) and all(np.array_equal(got[k], SG[k]) for k in SG)
    assert tconvert.main(["--pth-dir", str(tmp_path / "npz")]) == 1 and tconvert.KNOWN_PTH == jconvert.KNOWN_PTH
    # the networks from .pth and from .npz hold the same weights; the cache follows the path
    monkeypatch.setenv(tmatching.SUPERGLUE_WEIGHTS_ENV, str(pth))
    sp_pth = tsg.load_networks("cpu")[0]
    assert tsg.load_networks("cpu")[0] is sp_pth
    monkeypatch.setenv(tmatching.SUPERGLUE_WEIGHTS_ENV, str(tmp_path / "npz"))
    sp_npz = tsg.load_networks("cpu")[0]
    assert sp_npz is not sp_pth and all(torch.equal(a, b) for a, b in zip(sp_npz.state_dict().values(),
                                                                          sp_pth.state_dict().values()))
    other = write(str(tmp_path / "other"), seed=7)
    monkeypatch.setenv(tmatching.SUPERGLUE_WEIGHTS_ENV, os.path.dirname(other["superpoint_v1"]))
    assert not torch.equal(tsg.load_networks("cpu")[0].conv1a.weight, sp_npz.conv1a.weight)
