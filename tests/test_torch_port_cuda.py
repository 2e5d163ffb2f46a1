"""The port's CUDA kernels on the card, against their plain PyTorch twins.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without one.
The file imports no JAX, so it also runs where only the port's dependencies
are installed:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

Tolerances. Trunk kernels: max abs error within 2e-2 of the twin's max
|value|; kernel and twin take the same bf16 products with f32 sums in another
order (and dW/db with f32 atomics), so a value near a bf16 rounding boundary
may land one bf16 ulp (2^-8 relative) away, and such flips propagate through
the layers. Layout kernels: copies, bit-identical. Trilinear kernels: float32
with sums in another order (the backward adds with atomics, whose order
changes from run to run, so d_grid agrees to float32 rounding and not bit for
bit): 1e-5 of the twin's max |value| + 1e-6 (d_grid with 100,003 points in
one voxel, where each of 8 sums has 100,003 terms: 1e-4). Composite kernels: float32, the transmittance by a
warp scan instead of a cumprod: outputs 1e-5 abs, gradients 1e-4 of the plain
version's largest + 1e-6; rays with a sample whose transmittance lies within
1e-4 (relative) of the early-termination threshold 1e-3 are left out, since
the gate is a step and the two products round differently. Encoding
kernels: the forward is the plain chain's bits (the same float32 products, the
accurate sinf / cosf, one RNE rounding to bf16); the backward within 1e-5 of
the sum of its terms' sizes (the same sines and cosines, float32 sums over the
bands in another order).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from poseprobe_tpu_torch.models import scene_nerf
from poseprobe_tpu_torch.ops import compositing, fused_composite, fused_mlp, grid as grid_ops, layout, pe
from poseprobe_tpu_torch.train.trainer import JointTrainer, _bench_workload, build_scene_trainer, build_trainer

torch.set_num_threads(1)

REL_TOL = 2e-2
L, SKIP = 8, 4


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _close(out, ref):
    out, ref = out.float(), ref.float()
    assert out.shape == ref.shape
    if ref.numel():
        assert (out - ref).abs().max() <= REL_TOL * ref.abs().max()


def _inputs(n, seed=0, n_layers=L, skip=SKIP, width=256, L_3D=10):
    cfg = scene_nerf.SceneConfig(layers_feat=(width,) * n_layers, skip=(skip,), L_3D=L_3D)
    layers = scene_nerf.init_nerf_mlp(torch.Generator().manual_seed(seed), cfg)["feat"]
    layers = [{k: v.cuda() for k, v in la.items()} for la in layers]
    g = torch.Generator(device="cuda").manual_seed(seed)
    points = torch.rand((max(n, 1), 3), generator=g, device="cuda") * 6.0 - 3.0
    enc = pe.posenc_scene(points, cfg.L_3D, 1.0, cfg.barf_c2f)[:n]   # no points: the encoding's columns
    return layers, enc, g


def _padded(enc):
    return torch.nn.functional.pad(enc.to(torch.bfloat16), (0, fused_mlp.in_pad(enc.shape[1]) - enc.shape[1])).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_layers,skip", [
    (393_216, L, SKIP), (100_003, L, SKIP), (1, L, SKIP),
    (63, L, SKIP), (64, L, SKIP), (65, L, SKIP), (129, L, SKIP),    # around the 64-row warpgroup tile
    (5_000, 2, 1), (5_000, 3, 1), (5_000, 4, 3), (5_000, 8, 7),     # skip on the last layer
])
def test_trunk_kernels_match_twin(n, n_layers, skip):
    _need_card()
    layers, enc, g = _inputs(n, n_layers=n_layers, skip=skip)
    w, b = fused_mlp.pack_params(layers, skip)
    x = _padded(enc)
    before = fused_mlp.fwd_launches, fused_mlp.bwd_launches
    out = fused_mlp.trunk_fwd(x, w, b, n_layers, skip)
    ref = fused_mlp.trunk_fwd_plain(x, w, b, n_layers, skip)
    for o, r in zip(out, ref):
        _close(o, r)
    g_feat = (torch.randn((n, 256), generator=g, device="cuda") * 1e-3).to(torch.bfloat16)
    g_dens = (torch.randn(n, generator=g, device="cuda") * 1e-3).to(torch.bfloat16)
    feat, _, acts = ref
    out = fused_mlp.trunk_bwd(x, g_feat, g_dens, feat, acts, w, b, n_layers, skip)
    ref = fused_mlp.trunk_bwd_plain(x, g_feat, g_dens, feat, acts, w, b, n_layers, skip)
    torch.cuda.synchronize()
    for o, r in zip(out, ref):
        _close(o, r)
    assert (fused_mlp.fwd_launches, fused_mlp.bwd_launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [393_216, 65])
def test_trunk_fwd_without_stored_acts_matches_stored_call(n):
    """The visibility and eval renders call the forward with store_acts=False:
    no activations are written, and feat and the density equal the stored
    call's bit for bit (the same products in the same order)."""
    _need_card()
    layers, enc, _ = _inputs(n)
    w, b = fused_mlp.pack_params(layers, SKIP)
    x = _padded(enc)
    before = fused_mlp.fwd_launches
    feat, dens, acts = fused_mlp.trunk_fwd(x, w, b, L, SKIP)
    feat2, dens2, acts2 = fused_mlp.trunk_fwd(x, w, b, L, SKIP, store_acts=False)
    torch.cuda.synchronize()
    assert acts is not None and acts2 is None
    assert torch.equal(feat2, feat) and torch.equal(dens2, dens)
    assert fused_mlp.fwd_launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_layers,skip", [(100_003, L, SKIP), (5_000, 8, 7), (65, 2, 1)])
def test_trunk_bwd_density_column_and_last_db_match_twin(n, n_layers, skip):
    """The last layer's g is exact in bf16 (the feat mask and the bf16
    cotangents), so its db and the density column of its dW (the dW kernel's
    extra dot with g_dens) differ from the twin only by the order of the f32
    sums: element by element within 1e-4 relative + 1e-4 of the largest."""
    _need_card()
    layers, enc, g = _inputs(n, n_layers=n_layers, skip=skip)
    w, b = fused_mlp.pack_params(layers, skip)
    x = _padded(enc)
    feat, _, acts = fused_mlp.trunk_fwd_plain(x, w, b, n_layers, skip)
    g_feat = (torch.randn((n, 256), generator=g, device="cuda") * 1e-3).to(torch.bfloat16)
    g_dens = (torch.randn(n, generator=g, device="cuda") * 1e-3).to(torch.bfloat16)
    _, dw, db = fused_mlp.trunk_bwd(x, g_feat, g_dens, feat, acts, w, b, n_layers, skip)
    _, dw_ref, db_ref = fused_mlp.trunk_bwd_plain(x, g_feat, g_dens, feat, acts, w, b, n_layers, skip)
    torch.cuda.synchronize()
    K, NO, wo, bo = fused_mlp.layout(n_layers, skip, 256, 64)[-1]
    col, col_ref = dw[wo:wo + K * NO].view(K, NO)[:, 256], dw_ref[wo:wo + K * NO].view(K, NO)[:, 256]
    for o, r in ((col, col_ref), (db[bo:], db_ref[bo:])):
        torch.testing.assert_close(o, r, rtol=1e-4, atol=1e-4 * float(r.abs().max()))
    assert not dw[wo:wo + K * NO].view(K, NO)[:, 257:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("width,L_3D,n_layers,skip,n", [
    (128, 16, 8, 4, 100_003), (128, 10, 8, 4, 65), (128, 16, 3, 2, 5_000),   # m64n128, pads 128 / 64
    (256, 16, 8, 4, 100_003), (256, 20, 2, 1, 129),                          # the 8x256 kernels, pad 128
    (384, 10, 3, 1, 5_000), (512, 10, 8, 4, 100_003), (512, 20, 2, 1, 65),   # csrc/trunk_wide.cu
    (640, 10, 8, 7, 5_000), (1024, 20, 8, 4, 5_000),                         # a 128-column tail; pad 128
    (512, 10, 8, 4, 1), (512, 10, 8, 4, 0),                                  # one point; none (no launch)
])
def test_trunk_kernels_at_every_width_match_twin(width, L_3D, n_layers, skip, n):
    """Each kernel instantiation (`fused_mlp.kernel_name`) against the twin:
    forward (also without stored activations, bit for bit), backward (the
    last layer's db and density column of dW element by element, as in
    `test_trunk_bwd_density_column_and_last_db_match_twin`), and one launch
    of each counted under its name (none for no points)."""
    _need_card()
    layers, enc, g = _inputs(n, n_layers=n_layers, skip=skip, width=width, L_3D=L_3D)
    w, b = fused_mlp.pack_params(layers, skip)
    x = _padded(enc)
    pad = x.shape[1]
    names = [fused_mlp.kernel_name(k, width, pad) for k in ("fwd", "bwd")]
    before = [fused_mlp.launches[k] for k in names]
    out = fused_mlp.trunk_fwd(x, w, b, n_layers, skip)
    ref = fused_mlp.trunk_fwd_plain(x, w, b, n_layers, skip)
    for o, r in zip(out, ref):
        _close(o, r)
    feat2, dens2, acts2 = fused_mlp.trunk_fwd(x, w, b, n_layers, skip, store_acts=False)
    assert acts2 is None and torch.equal(feat2, out[0]) and torch.equal(dens2, out[1])
    g_feat = (torch.randn((n, width), generator=g, device="cuda") * 1e-3).to(torch.bfloat16)
    g_dens = (torch.randn(n, generator=g, device="cuda") * 1e-3).to(torch.bfloat16)
    feat, _, acts = ref
    out = fused_mlp.trunk_bwd(x, g_feat, g_dens, feat, acts, w, b, n_layers, skip)
    ref = fused_mlp.trunk_bwd_plain(x, g_feat, g_dens, feat, acts, w, b, n_layers, skip)
    torch.cuda.synchronize()
    for o, r in zip(out, ref):
        _close(o, r)
    K, NO, wo, bo = fused_mlp.layout(n_layers, skip, width, pad)[-1]
    col, col_ref = (d[wo:wo + K * NO].view(K, NO)[:, width] for d in (out[1], ref[1]))
    for o, r in ((col, col_ref), (out[2][bo:], ref[2][bo:])):
        torch.testing.assert_close(o, r, rtol=1e-4, atol=1e-4 * float(r.abs().max()))
    assert [fused_mlp.launches[k] for k in names] == [before[0] + 2 * (n > 0), before[1] + (n > 0)]


@pytest.mark.cuda
def test_fused_trunk_autograd_matches_cpu_twin():
    """The autograd path on the card (kernels) against the same call on the CPU
    (twin). The two forwards may round a pre-activation near 0 to opposite
    sides of the ReLU, which reroutes that point's gradient: the per-point
    input gradient is held by its relative L2 error; the outputs and the
    parameter gradients (sums over all points) element by element."""
    _need_card()
    layers, enc, _ = _inputs(20_000, seed=1)
    results = []
    for dev in ("cuda", "cpu"):
        ls = [{k: v.detach().to(dev).requires_grad_(True) for k, v in la.items()} for la in layers]
        e = enc.detach().to(dev).requires_grad_(True)
        raw, feat = fused_mlp.fused_trunk(e, ls, SKIP)
        (torch.nn.functional.softplus(raw).sum() + (feat.float() ** 2).sum() * 1e-3).backward()
        results.append([raw, feat] + [la[k].grad for la in ls for k in ("w", "b")] + [e.grad])
    for o, r in zip(results[0][:-1], results[1][:-1]):
        _close(o.detach().cpu(), r.detach())
    g_card, g_cpu = results[0][-1].cpu(), results[1][-1]
    assert torch.linalg.norm(g_card - g_cpu) <= REL_TOL * torch.linalg.norm(g_cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("skip", [1, 7])                # the skip after the first layer, and on the last
@pytest.mark.parametrize("n", [1, 127, "ragged"])
@pytest.mark.parametrize("L_3D", [10, 16])              # input 63 (pad 64) and 99 (pad 128)
def test_narrow_chain_matches_twin(L_3D, n, skip):
    """The H = 128 backward (the chain of csrc/trunk_narrow.cu, then dW)
    through `trunk_bwd` against the twin: denc, dW and db within REL_TOL of
    their max, the last layer's db and density column of dW element by
    element (as in `test_trunk_bwd_density_column_and_last_db_match_twin`).
    n = 1 and 127 leave sub-tiles of the one 256-point tile empty; "ragged"
    has more tiles than three per multiprocessor, so every persistent block
    walks several, and ends inside a tile. db is summed from per-block copies
    in a fixed order, so a second call gives it bit for bit."""
    _need_card()
    ragged = n == "ragged"
    if ragged:
        n = fused_mlp.NARROW_TILE * 3 * fused_mlp._sms(torch.device("cuda")) + 77
    layers, enc, g = _inputs(n, n_layers=L, skip=skip, width=128, L_3D=L_3D)
    w, b = fused_mlp.pack_params(layers, skip)
    x = _padded(enc)
    plan = fused_mlp.narrow_plan(n, L, x.shape[1], fused_mlp._sms(x.device))
    assert plan["tiles"] > 3 * plan["blocks"] if ragged else plan["blocks"] == 1
    feat, _, acts = fused_mlp.trunk_fwd_plain(x, w, b, L, skip)
    g_feat = (torch.randn((n, 128), generator=g, device="cuda") * 1e-3).to(torch.bfloat16)
    g_dens = (torch.randn(n, generator=g, device="cuda") * 1e-3).to(torch.bfloat16)
    name = fused_mlp.kernel_name("bwd", 128, x.shape[1])
    before = fused_mlp.launches[name]
    out = fused_mlp.trunk_bwd(x, g_feat, g_dens, feat, acts, w, b, L, skip)
    again = fused_mlp.trunk_bwd(x, g_feat, g_dens, feat, acts, w, b, L, skip)
    ref = fused_mlp.trunk_bwd_plain(x, g_feat, g_dens, feat, acts, w, b, L, skip)
    torch.cuda.synchronize()
    for o, r in zip(out, ref):
        _close(o, r)
    K, NO, wo, bo = fused_mlp.layout(L, skip, 128, x.shape[1])[-1]
    col, col_ref = (d[wo:wo + K * NO].view(K, NO)[:, 128] for d in (out[1], ref[1]))
    for o, r in ((col, col_ref), (out[2][bo:], ref[2][bo:])):
        torch.testing.assert_close(o, r, rtol=1e-4, atol=1e-4 * float(r.abs().max()))
    assert torch.equal(again[2], out[2])
    assert fused_mlp.launches[name] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("L_3D", [10, 16])
def test_narrow_backward_with_no_points(L_3D):
    """No points: the wrapper returns empty denc and zero dW and db without
    launching."""
    _need_card()
    layers, enc, _ = _inputs(0, n_layers=L, skip=SKIP, width=128, L_3D=L_3D)
    w, b = fused_mlp.pack_params(layers, SKIP)
    x = _padded(enc)
    feat, _, acts = fused_mlp.trunk_fwd_plain(x, w, b, L, SKIP)
    g_feat = torch.zeros((0, 128), dtype=torch.bfloat16, device="cuda")
    g_dens = torch.zeros(0, dtype=torch.bfloat16, device="cuda")
    name = fused_mlp.kernel_name("bwd", 128, x.shape[1])
    before = fused_mlp.launches[name]
    denc, dw, db = fused_mlp.trunk_bwd(x, g_feat, g_dens, feat, acts, w, b, L, SKIP)
    torch.cuda.synchronize()
    assert denc.shape == (0, x.shape[1]) and dw.shape == w.shape and db.shape == b.shape
    assert not dw.any() and not db.any() and fused_mlp.launches[name] == before


# the trunk instantiations (width, L_3D) held at every checkpoint stride: the five of
# `fused_mlp.KERNEL_NAMES` (L_3D 10 pads to 64, 16 to 128) and the wide cell's 8x512
CKPT_CELLS = [(256, 10), (256, 16), (128, 10), (128, 16), (384, 10), (512, 10)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5_000, 1, 0])
@pytest.mark.parametrize("width,L_3D", CKPT_CELLS)
def test_trunk_strides_match_stride_one(width, L_3D, n):
    """At checkpoint strides 0, 2 and 3 (8 layers, skip 4): the forward's
    feat and density and its stored layers are stride 1's bit for bit; the
    remat kernel's buffer is stride 1's `acts` bit for bit (and within
    REL_TOL of its plain version); the backward's denc is stride 1's bit for
    bit, and so are db at width 128 (the narrow chain adds its blocks' copies
    in order) and dW from width 384 (the wide dW adds its slices' copies);
    the others are summed with f32 atomics in a run-dependent order, so they
    are held as the last layer's db is held against the twin (1e-4 relative
    + 1e-4 of the largest). Each backward at a stride other than 1 launches
    the remat once (none for no points), and the backward agrees with its
    plain version on the layers the remat refilled (REL_TOL of the max, as
    `test_trunk_kernels_match_twin`; the plain remat, held apart, may round a
    value to the other side of a ReLU and so reroute one point's gradient)."""
    _need_card()
    layers, enc, g = _inputs(n, width=width, L_3D=L_3D)
    w, b = fused_mlp.pack_params(layers, SKIP)
    x = _padded(enc)
    pad = x.shape[1]
    feat, dens, full = fused_mlp.trunk_fwd(x, w, b, L, SKIP)
    g_feat = (torch.randn((n, width), generator=g, device="cuda") * 1e-3).to(torch.bfloat16)
    g_dens = (torch.randn(n, generator=g, device="cuda") * 1e-3).to(torch.bfloat16)
    want = fused_mlp.trunk_bwd(x, g_feat, g_dens, feat, full, w, b, L, SKIP)
    exact = {"denc": True, "dw": width not in fused_mlp.WGMMA_WIDTHS, "db": width == fused_mlp.NARROW_WIDTH}
    name = fused_mlp.kernel_name("remat", width, pad)
    for ckpt in (0, 2, 3):
        stored = fused_mlp.stored_layers(L, ckpt)
        f, d, acts = fused_mlp.trunk_fwd(x, w, b, L, SKIP, store_acts=stored)
        assert torch.equal(f, feat) and torch.equal(d, dens)
        assert (acts is None) if ckpt == 0 else torch.equal(acts, full[list(stored)])
        before = fused_mlp.launches[name]
        remat = fused_mlp.trunk_remat(x, acts, w, b, L, SKIP, ckpt)
        got = fused_mlp.trunk_bwd(x, g_feat, g_dens, f, acts, w, b, L, SKIP, ckpt)
        ref = fused_mlp.trunk_bwd_plain(x, g_feat, g_dens, f, remat, w, b, L, SKIP)
        torch.cuda.synchronize()
        assert torch.equal(remat, full), ckpt
        _close(remat, fused_mlp.trunk_remat_plain(x, acts, w, b, L, SKIP, ckpt))
        for key, o, r, p in zip(("denc", "dw", "db"), got, want, ref):
            if exact[key]:
                assert torch.equal(o, r), (ckpt, key)
            else:
                torch.testing.assert_close(o, r, rtol=1e-4, atol=1e-4 * float(r.abs().max()) if n else 0.0)
            _close(o, p)
        assert fused_mlp.launches[name] == before + 2 * (n > 0), ckpt


@pytest.mark.cuda
def test_stride_zero_mid_step_replays_as_a_cuda_graph(monkeypatch):
    """The small scene trainer's mid step with `fused_mlp.TRUNK_CKPT` 0:
    every trunk call keeps no layer and each backward runs the remat kernel
    first. A superstep window and its replays agree with eager steps
    (`_window_against_eager`), and the eager steps launch the remat once per
    backward."""
    _need_card()
    from poseprobe_tpu_torch.train import graphs
    monkeypatch.setattr(fused_mlp, "TRUNK_CKPT", 0)
    tr = build_scene_trainer(small=True, device="cuda")
    sm = tr.cfg.scene_model
    H, pad = sm.layers_feat[0], fused_mlp.in_pad(sm.input_3d_dim)
    tr.global_step = tr.fine_start + 1
    launched = dict(zip(fused_mlp.KERNEL_NAMES, _window_against_eager(tr)[len(graphs._COUNTERS):]))
    bwd, remat = (launched[fused_mlp.kernel_name(k, H, pad)] for k in ("bwd", "remat"))
    assert bwd > 0 and remat == bwd, launched


def _watch_encodings(monkeypatch) -> list:
    """A list that gets, for each call of `pe.posenc_scene_padded`, whether its points take a gradient."""
    with_grad, encode = [], pe.posenc_scene_padded
    monkeypatch.setattr(pe, "posenc_scene_padded",
                        lambda x, *a, **k: with_grad.append(x.requires_grad) or encode(x, *a, **k))
    return with_grad


@pytest.mark.cuda
def test_scene_step_runs_through_the_kernels(monkeypatch):
    """A coarse and a mid step of the small scene trainer: the trunk kernels
    carry every render, the encoding kernel writes the input of each trunk
    forward, and its backward runs once for each render whose points take a
    gradient (through the poses while their window is open, through the
    rendered depth in depth consistency)."""
    _need_card()
    tr = build_scene_trainer(small=True, device="cuda")
    with_grad = _watch_encodings(monkeypatch)
    for start, per_step in ((tr.cfg.object_train.N_iters + 1, (1, 1)), (tr.fine_start + 1, (6, 4))):
        tr.global_step = start
        fused_mlp.fwd_launches = fused_mlp.bwd_launches = 0
        enc_before = dict(pe.launches)
        with_grad.clear()
        m = tr.step()
        assert all(np.isfinite(v.item()) for v in m.values()), m
        assert (fused_mlp.fwd_launches, fused_mlp.bwd_launches) == per_step
        assert (pe.launches["posenc_scene_fwd"] - enc_before["posenc_scene_fwd"],
                pe.launches["posenc_scene_bwd"] - enc_before["posenc_scene_bwd"]) == (per_step[0], sum(with_grad))
        assert sum(with_grad) <= per_step[1]


# ---------------------------------------------------------------- the scene encoding


def _enc_points(n, L, seed=0):
    """n points up to the scene's bound (|x| <= 4), every 97th up to 100: far
    enough that x * f_k takes sinf's slow range reduction at L = 10 too."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.rand((n, 3), generator=g, device="cuda") * 2.0 - 1.0) * 4.0
    x[::97] *= 25.0
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("n", [100_003, 64, 1])
@pytest.mark.parametrize("progress", [0.5, 1.0])              # inside the BARF window, and past it
@pytest.mark.parametrize("include_pi,add_raw", [(True, True), (False, True), (True, False), (False, False)])
@pytest.mark.parametrize("L_enc,pad", [(10, 64), (16, 128)])
def test_posenc_kernel_is_the_plain_chains_bits(L_enc, pad, include_pi, add_raw, progress, n):
    _need_card()
    x = _enc_points(n, L_enc)
    before = pe.launches["posenc_scene_fwd"]
    enc = pe.posenc_scene_padded(x, L_enc, progress, (0.4, 0.7), pad, include_pi=include_pi, add_raw=add_raw)
    ref = pe.posenc_scene_padded_plain(x, L_enc, progress, (0.4, 0.7), pad, include_pi=include_pi, add_raw=add_raw)
    torch.cuda.synchronize()
    assert pe.launches["posenc_scene_fwd"] == before + 1
    assert enc.shape == ref.shape == (n, pad) and enc.dtype == ref.dtype == torch.bfloat16
    differ = (enc.view(torch.int16) != ref.view(torch.int16)).sum().item()
    assert differ == 0, f"{differ} of {enc.numel()} columns differ from the plain chain's"


@pytest.mark.cuda
@pytest.mark.parametrize("add_raw", [True, False])
@pytest.mark.parametrize("L_enc,pad,progress", [(10, 64, 0.5), (16, 128, 1.0)])
@pytest.mark.parametrize("n", [393_216, 1_001])
def test_posenc_backward_kernel_matches_autograd(L_enc, pad, progress, add_raw, n):
    """dx against autograd through the plain chain in float32, on the card:
    within 1e-5 of the sum of the sizes of each sum's terms."""
    _need_card()
    x = _enc_points(n, L_enc, seed=1).requires_grad_(True)
    g = torch.Generator(device="cuda").manual_seed(2)
    denc = torch.randn((n, pad), generator=g, device="cuda").to(torch.bfloat16)
    before = pe.launches["posenc_scene_bwd"]
    pe.posenc_scene_padded(x, L_enc, progress, (0.4, 0.7), pad, add_raw=add_raw).backward(denc)
    got, x.grad = x.grad, None
    pe.posenc_scene_padded_plain(x, L_enc, progress, (0.4, 0.7), pad, add_raw=add_raw).backward(denc)
    torch.cuda.synchronize()
    assert pe.launches["posenc_scene_bwd"] == before + 1
    raw = 3 if add_raw else 0
    w = pe.barf_weights(progress, L_enc, (0.4, 0.7), device="cuda")
    f = 2.0 ** torch.arange(L_enc, dtype=torch.float32, device="cuda") * torch.pi
    d = denc.float()
    sizes = torch.stack([(w * f * (d[:, raw + c * 2 * L_enc:raw + (c + 1) * 2 * L_enc].abs().reshape(-1, 2, L_enc)
                                   .sum(1))).sum(-1) for c in range(3)], dim=1)
    if add_raw:
        sizes = sizes + d[:, :3].abs()
    assert ((got - x.grad).abs() <= 1e-5 * sizes + 1e-30).all(), (got - x.grad).abs().max().item()


@pytest.mark.cuda
def test_posenc_kernel_follows_a_progress_tensor_in_a_cuda_graph():
    """The BARF weights reach the kernel as a device tensor: a captured graph
    replayed after the progress tensor changed encodes at the new progress."""
    _need_card()
    x = _enc_points(5_000, 10)
    progress = torch.tensor(0.45, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                 # warm up (builds the library) off the capture
        pe.posenc_scene_padded(x, 10, progress, (0.4, 0.7), 64)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        enc = pe.posenc_scene_padded(x, 10, progress, (0.4, 0.7), 64)
    for p in (0.5, 0.62, 1.0):
        progress.fill_(p)
        graph.replay()
        torch.cuda.synchronize()
        # the plain chain at the same float32 progress: a Python float takes the window's arithmetic in double
        ref = pe.posenc_scene_padded_plain(x, 10, torch.tensor(p, device="cuda"), (0.4, 0.7), 64)
        assert torch.equal(enc, ref), p


@pytest.mark.cuda
def test_posenc_kernels_carry_the_early_step_and_a_render(monkeypatch):
    """An early step of the small joint trainer and a render: the encoding
    kernel writes the input of every trunk forward; its backward runs once for
    each render of the step whose points take a gradient, and in no render."""
    _need_card()
    from poseprobe_tpu_torch.eval import evaluator
    tr = build_trainer(small=True, device="cuda")
    tr.global_step = 1
    with_grad = _watch_encodings(monkeypatch)

    def counts():
        return (fused_mlp.fwd_launches, fused_mlp.bwd_launches, pe.launches["posenc_scene_fwd"],
                pe.launches["posenc_scene_bwd"])
    before = counts()
    tr.step()
    trunk_fwd, trunk_bwd, enc_fwd, enc_bwd = (b - a for a, b in zip(before, counts()))
    assert trunk_fwd > 0 and enc_fwd == trunk_fwd and enc_bwd == sum(with_grad) <= trunk_bwd
    data = tr.data
    before = counts()
    out = evaluator.render_full(tr.scene_params, tr.cfg.scene_model, data.poses_gt_w2c[data.i_test[0]],
                                data.Ks[data.i_test[0]], 16, 24, (data.near, data.far), chunk=128)
    assert torch.isfinite(out["rgb"]).all()
    trunk_fwd, trunk_bwd, enc_fwd, enc_bwd = (b - a for a, b in zip(before, counts()))
    assert trunk_fwd == 3 * (1 + tr.cfg.scene_model.fine_sampling) and enc_fwd == trunk_fwd
    assert trunk_bwd == enc_bwd == 0


# ---------------------------------------------------------------- layout kernels


def _randn(*shape, seed=0):
    return torch.randn(shape, generator=torch.Generator(device="cuda").manual_seed(seed), device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(884_736, 13), (13, 884_736), (884_736, 16), (1000, 77), (77, 1000),
                                   (100_003, 7), (7, 100_003), (33, 5), (32, 33), (1, 1), (257, 32)])
def test_transpose2d_kernel_is_bit_exact(shape):
    _need_card()
    x = _randn(*shape)
    before = layout.transpose2d_launches
    out = layout.transpose2d(x)
    torch.cuda.synchronize()
    assert out.is_contiguous() and torch.equal(out, layout.transpose2d_plain(x))
    assert layout.transpose2d_launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("V,P,C", [(884_736, 16, 13), (884_736, 128, 13), (100_003, 16, 13), (5000, 40, 33),
                                   (777, 4, 3), (10, 16, 16), (300, 32, 1), (300, 33, 33)])
def test_transpose_slice_kernel_is_bit_exact(V, P, C):
    _need_card()
    x = _randn(V, P, seed=1)
    before = layout.transpose_slice_launches
    out = layout.transpose_slice(x, C)
    torch.cuda.synchronize()
    assert out.is_contiguous() and torch.equal(out, layout.transpose_slice_plain(x, C))
    assert layout.transpose_slice_launches == before + 1


# a block of the copy kernel moves 16 B x 256 threads = 4096 B; 16384 B = 4 blocks = one bulk-ring chunk
_COPY_SHAPES = [((884_736, 16), torch.float32), ((100_003, 13), torch.float32),
                ((7,), torch.float32), ((3, 5, 7, 11), torch.float32),
                ((1_000_003,), torch.uint8), ((4099, 3), torch.bfloat16),
                ((4096 - 16,), torch.uint8), ((4096 + 16,), torch.uint8),
                ((16384 - 16,), torch.uint8), ((16384,), torch.uint8),
                ((16384 + 16,), torch.uint8), ((16385,), torch.uint8)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", _COPY_SHAPES)
def test_materialize_kernel_is_bit_exact(shape, dtype):
    _need_card()
    x = (_randn(*shape, seed=2) * 50).to(dtype)
    before = layout.materialize_launches
    out = layout.materialize(x)
    torch.cuda.synchronize()
    assert out.data_ptr() != x.data_ptr() and out.dtype == dtype and torch.equal(out, x)
    assert layout.materialize_launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("design", [1, 2, 3])
@pytest.mark.parametrize("shape,dtype", _COPY_SHAPES)
def test_materialize_designs_are_bit_exact(shape, dtype, design):
    """The copy designs `materialize` was chosen against (timed beside it by
    chip_smoke.py) copy every byte, the ragged tail included."""
    _need_card()
    x = (_randn(*shape, seed=2) * 50).to(dtype)
    out = torch.zeros_like(x)
    lib = layout._lib()
    layout._check(lib, lib.materialize_design(x.data_ptr(), out.data_ptr(), x.numel() * x.element_size(), design,
                                              torch.cuda.current_stream().cuda_stream), "materialize_design")
    torch.cuda.synchronize()
    assert torch.equal(out, x)


@pytest.mark.cuda
def test_layout_wrappers_raise_on_what_the_kernels_do_not_take():
    _need_card()
    x = _randn(8, 6)
    with pytest.raises(ValueError):
        layout.transpose2d(x.t())                       # not contiguous
    with pytest.raises(ValueError):
        layout.transpose2d(x.double())
    with pytest.raises(ValueError):
        layout.transpose_slice(x, 7)                    # C > P
    with pytest.raises(ValueError):
        layout.materialize(x[:, :3])


# ---------------------------------------------------------------- trilinear kernels


def _tri_close(out, ref):
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max() + 1e-6


def _tri_case(C, size, n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    lo = torch.tensor([-0.5, -0.45, -0.55], device="cuda")
    hi = torch.tensor([0.5, 0.55, 0.45], device="cuda")
    grid = torch.randn((C,) + size, generator=g, device="cuda")
    pts = torch.rand((n, 3), generator=g, device="cuda") * (hi - lo) * 1.2 + lo - 0.1 * (hi - lo)
    n8 = n // 8
    top = torch.tensor(size, device="cuda") - 1.0
    ijk = torch.stack([torch.randint(0, s, (n8,), generator=g, device="cuda") for s in size], -1).float()
    pts[:n8] = lo + ijk / top * (hi - lo)                     # voxel corners, the far faces included
    pick = torch.rand((n8, 3), generator=g, device="cuda") < 0.5
    pts[n8:2 * n8] = torch.where(pick, lo.expand(n8, 3), hi.expand(n8, 3))
    return grid, pts, lo, hi, torch.randn((n, C), generator=g, device="cuda"), \
        torch.randn((n, C, 3), generator=g, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("barrier", ["0", "1"])
@pytest.mark.parametrize("C,size,n", [(1, (96, 96, 96), 115_712), (13, (96, 96, 96), 58_368),
                                      (13, (96, 96, 96), 100_003), (3, (7, 5, 9), 999), (12, (2, 2, 2), 64)])
def test_trilinear_kernels_match_autograd_twin(C, size, n, barrier, monkeypatch):
    _need_card()
    monkeypatch.setenv("POSEPROBE_SCATTER_BARRIER", barrier)
    grid, pts, lo, hi, ct_v, ct_g = _tri_case(C, size, n, seed=C + n)
    before = (grid_ops.fwd_launches, grid_ops.bwd_launches, layout.materialize_launches)
    gk, pk = grid.clone().requires_grad_(True), pts.clone().requires_grad_(True)
    gt, pt = grid.clone().requires_grad_(True), pts.clone().requires_grad_(True)
    val, grad = grid_ops.trilinear_sample_with_grad(gk, pk, lo, hi)
    rval, rgrad = grid_ops.trilinear_vg_reference(gt, pt, lo, hi)
    torch.autograd.backward([val, grad], [ct_v, ct_g])
    torch.autograd.backward([rval, rgrad], [ct_v, ct_g])
    torch.cuda.synchronize()
    for o, r in ((val, rval), (grad, rgrad), (gk.grad, gt.grad), (pk.grad, pt.grad)):
        _tri_close(o.detach(), r.detach())
    # value only, gradient to the grid only (the early step's merged lookup)
    gk2 = grid.clone().requires_grad_(True)
    grid_ops.trilinear_sample(gk2, pts, lo, hi).backward(ct_v)
    gt2 = grid.clone().requires_grad_(True)
    grid_ops.trilinear_sample_reference(gt2, pts, lo, hi).backward(ct_v)
    _tri_close(gk2.grad, gt2.grad)
    staged = int(barrier == "1" and C > 1)
    assert (grid_ops.fwd_launches, grid_ops.bwd_launches, layout.materialize_launches) == (
        before[0] + 2, before[1] + 2, before[2] + 2 * staged)


@pytest.mark.cuda
def test_trilinear_kernel_equals_its_plain_formulas():
    """The kernels against `trilinear_fwd_plain` / `trilinear_bwd_plain` (the
    same formulas in PyTorch ops) on the card."""
    _need_card()
    grid, pts, lo, hi, ct_v, ct_g = _tri_case(13, (24, 20, 28), 5000, seed=3)
    for o, r in zip(grid_ops.trilinear_fwd(grid, pts, lo, hi, True),
                    grid_ops.trilinear_fwd_plain(grid, pts, lo, hi, True)):
        _tri_close(o, r)
    for o, r in zip(grid_ops.trilinear_bwd(grid, pts, lo, hi, ct_v, ct_g),
                    grid_ops.trilinear_bwd_plain(grid, pts, lo, hi, ct_v, ct_g)):
        _tri_close(o, r)
    with pytest.raises(ValueError):
        grid_ops.trilinear_fwd(grid, pts.double(), lo, hi, True)
    with pytest.raises(ValueError):
        grid_ops.trilinear_fwd(grid.transpose(1, 3), pts, lo, hi, True)        # not contiguous
    with pytest.raises(ValueError):
        grid_ops.trilinear_bwd(grid.reshape(13, -1).t().contiguous().t().reshape(grid.shape), pts, lo, hi,
                               ct_v, ct_g)                                     # [V, C] rows viewed as the grid
    with pytest.raises(ValueError):
        grid_ops.trilinear_sample(torch.zeros((1, 1, 4, 4), device="cuda"), pts, lo, hi)   # a 1-voxel axis


def _bwd_direct(grid, pts, lo, hi, ct_v, ct_g, d_grid, d_pts):
    """One launch of the backward kernel into given d_grid and d_pts buffers."""
    lib, ptr = grid_ops._lib(), grid_ops._ptr
    C, X, Y, Z = grid.shape
    grid_ops._check(lib, lib.trilinear_bwd(
        ptr(grid), ptr(pts), ptr(lo), ptr(hi), ptr(ct_v), ptr(ct_g), X, Y, Z, C, pts.shape[0], ptr(d_grid),
        None, None, ptr(d_pts), torch.cuda.current_stream().cuda_stream), "trilinear_bwd")


def _off16(shape):
    """A zeroed float32 buffer of `shape` that starts 4 bytes past a 16-byte boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, device="cuda")[1:].view(shape)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(24, 20, 28), (7, 5, 9)])
@pytest.mark.parametrize("C", [1, 12, 13, 16])
def test_trilinear_kernels_match_plain_at_every_channel_count(C, size):
    """At a ragged point count, on a grid whose voxel count is (24 x 20 x 28)
    or is not (7 x 5 x 9) a multiple of 4: the forward from the grid and from
    a copy 4 bytes off a 16-byte boundary; the backward through the wrapper
    and, by a direct launch, into a gradient 4 bytes off and d_pts into a
    buffer filled with NaN, so a point the kernel does not store shows. All
    against the plain versions."""
    _need_card()
    n = 1001
    grid, pts, lo, hi, ct_v, ct_g = _tri_case(C, size, n, seed=C * 7 + size[0])
    off = _off16(grid.shape).copy_(grid)
    for with_grad in (False, True):
        cg = ct_g if with_grad else None
        ref_f = grid_ops.trilinear_fwd_plain(grid, pts, lo, hi, with_grad)
        for g_in in (grid, off):
            for o, r in zip(grid_ops.trilinear_fwd(g_in, pts, lo, hi, with_grad), ref_f):
                if o is not None:
                    _tri_close(o, r)
        r_grid, r_pts = grid_ops.trilinear_bwd_plain(grid, pts, lo, hi, ct_v, cg, True, True)
        for o, r in zip(grid_ops.trilinear_bwd(grid, pts, lo, hi, ct_v, cg, True, True), (r_grid, r_pts)):
            _tri_close(o, r)
        d_grid, d_pts = _off16(grid.shape), torch.full((n, 3), float("nan"), device="cuda")
        _bwd_direct(off, pts, lo, hi, ct_v, cg, d_grid, d_pts)
        torch.cuda.synchronize()
        _tri_close(d_grid, r_grid)
        assert torch.isfinite(d_pts).all()
        _tri_close(d_pts, r_pts)


def _edge_points(kind, size, n, lo, hi, seed):
    """`one_voxel`: all n points inside one voxel (every atomic on the same 8
    rows); `faces`: index coordinates on multiples of 8 on most axes."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    top = torch.tensor(size, device="cuda") - 1.0
    if kind == "one_voxel":
        ijk = torch.floor(top / 2) + torch.rand((n, 3), generator=g, device="cuda")
    else:
        ijk = torch.stack([torch.randint(0, (s + 7) // 8, (n,), generator=g, device="cuda") * 8.0 for s in size], -1)
        ijk = torch.where(torch.rand((n, 3), generator=g, device="cuda") < 0.3,
                          torch.rand((n, 3), generator=g, device="cuda") * top, torch.minimum(ijk, top))
    return (lo + ijk / top * (hi - lo)).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("C,size,n,kind", [
    (1, (96, 96, 96), 0, "spread"), (13, (96, 96, 96), 0, "spread"), (13, (96, 96, 96), 1, "spread"),
    (1, (96, 96, 96), 100_003, "one_voxel"), (13, (96, 96, 96), 100_003, "one_voxel"),
    (13, (96, 96, 96), 20_000, "faces"), (3, (17, 9, 11), 5_000, "faces"), (20, (10, 12, 9), 3_000, "spread"),
])
def test_trilinear_kernels_at_edge_cases(C, size, n, kind):
    """The kernels against their plain versions on the same rows and against
    the autograd twin with no point, one point, 100,003 points in one voxel
    (contention on 8 rows), points on multiples of 8 voxels, ragged grids and
    20 channels. In one voxel each of the 8 d_grid rows sums 100,003 float32
    terms, in another order than the reference's; the order alone moves such
    a sum by about 1e-5 of its size (1.1e-5 measured on an H100), so there
    d_grid is held to 1e-4 of max |reference|; every other output to the
    usual 1e-5."""
    _need_card()
    grid, pts, lo, hi, ct_v, ct_g = _tri_case(C, size, n, seed=C + n + 1)
    if kind != "spread":
        pts = _edge_points(kind, size, n, lo, hi, seed=n + 2)

    def close(out, ref, summed=False):
        assert out.shape == ref.shape
        if out.numel():
            rel = 1e-4 if summed and kind == "one_voxel" else 1e-5
            assert (out - ref).abs().max() <= rel * ref.abs().max() + 1e-6

    for with_grad in (False, True):
        cg = ct_g if with_grad else None
        for o, r in zip(grid_ops.trilinear_fwd(grid, pts, lo, hi, with_grad),
                        grid_ops.trilinear_fwd_plain(grid, pts, lo, hi, with_grad)):
            if o is not None:
                close(o, r)
        d_grid, d_pts = grid_ops.trilinear_bwd(grid, pts, lo, hi, ct_v, cg, True, with_grad)
        r_grid, r_pts = grid_ops.trilinear_bwd_plain(grid, pts, lo, hi, ct_v, cg, True, with_grad)
        close(d_grid, r_grid, summed=True)
        if with_grad:
            close(d_pts, r_pts)
    gk, pk = grid.clone().requires_grad_(True), pts.clone().requires_grad_(True)
    gt, pt = grid.clone().requires_grad_(True), pts.clone().requires_grad_(True)
    val, grad = grid_ops.trilinear_sample_with_grad(gk, pk, lo, hi)
    rval, rgrad = grid_ops.trilinear_vg_reference(gt, pt, lo, hi)
    torch.autograd.backward([val, grad], [ct_v, ct_g])
    torch.autograd.backward([rval, rgrad], [ct_v, ct_g])
    torch.cuda.synchronize()
    for o, r in ((val, rval), (grad, rgrad), (pk.grad, pt.grad)):
        close(o.detach(), r.detach())
    close(gk.grad, gt.grad, summed=True)
    if n == 0:
        assert bool((gk.grad == 0).all())


@pytest.mark.cuda
def test_resize_trilinear_on_the_card_matches_cpu():
    _need_card()
    grid = _randn(3, 9, 8, 10, seed=4)
    out = grid_ops.resize_trilinear(grid, (13, 12, 7))
    ref = grid_ops.resize_trilinear(grid.cpu(), (13, 12, 7))
    assert (out.cpu() - ref).abs().max() <= 1e-5


# ---------------------------------------------------------------- the early step


@pytest.mark.cuda
def test_early_step_runs_through_the_kernels():
    """Per early step: one trunk forward and backward (the scene half), three
    trilinear forwards and backwards (the deformed 1-channel value+gradient
    lookup, the merged 13-channel lookup, the reprojection term's lookup) on
    the grids' own layout, so no transpose2d and no transpose_slice;
    `materialize` only under POSEPROBE_SCATTER_BARRIER=1, with the same loss."""
    _need_card()
    tr = build_trainer(small=True, device="cuda")
    tr.global_step = 1

    def counts():
        return (fused_mlp.fwd_launches, fused_mlp.bwd_launches, grid_ops.fwd_launches, grid_ops.bwd_launches,
                layout.transpose2d_launches, layout.transpose_slice_launches, layout.materialize_launches)

    flags = tr.phase_flags(1)
    draws = tr.sample_draws(flags)
    with torch.no_grad():
        loss, _ = tr.joint_loss(tr.obj_params, tr.scene_params, tr.pose_params, 1, flags, draws)
    before = counts()
    os.environ["POSEPROBE_SCATTER_BARRIER"] = "1"
    try:
        m = tr.step(draws)
    finally:
        os.environ.pop("POSEPROBE_SCATTER_BARRIER")
    assert all(np.isfinite(v.item()) for v in m.values()), m
    assert abs(m["loss_total"].item() - loss.item()) <= 1e-6 * abs(loss.item())
    assert tuple(b - a for a, b in zip(before, counts())) == (1, 1, 3, 3, 0, 0, 1)
    before = counts()
    m = tr.step()
    assert all(np.isfinite(v.item()) for v in m.values()), m
    assert tuple(b - a for a, b in zip(before, counts())) == (1, 1, 3, 3, 0, 0, 0)


@pytest.mark.cuda
def test_spans_claim_the_kernels_of_an_eager_step():
    """An eager early step of the small joint trainer under torch.profiler,
    split by the benchmark's `portbench/spans.py`: every trunk kernel, the
    backward's `trunk_bwd_*` included (through autograd's sequence numbers),
    lands under `poseprobe.scene.trunk`; every trilinear kernel, forward and
    backward, under `poseprobe.object.field`; the encoding kernel under
    `poseprobe.scene.encode`; device time that no host op
    claims is under 1% of the step's."""
    _need_card()
    from portbench import spans
    tr = build_trainer(small=True, device="cuda")

    def unit():
        tr.global_step = 1
        tr.step()
        torch.cuda.synchronize()
    got = spans.attribute(*spans.record(unit, 2))
    assert got["device_s"][spans.UNLINKED] < 0.01 * got["total_s"], got["device_s"]
    for kind, span in (("trunk_", "poseprobe.scene.trunk"), ("trilinear_", "poseprobe.object.field"),
                       ("posenc_scene_", "poseprobe.scene.encode")):
        mine = {k: v for k, v in got["by_kernel"].items() if kind in k[1] and abs(v) > 1e-12}
        # the step's scene points take no gradient, so the encoding has no backward kernel to place
        assert any(("_bwd" if kind != "posenc_scene_" else "_fwd") in name for _, name in mine), (kind, mine)
        assert {where for where, _ in mine} == {span}, (kind, mine)


@pytest.mark.cuda
def test_preset_step_replays_as_a_cuda_graph_with_the_feature_term(tmp_path):
    """The `dtu_generic` preset (its 8x256 bf16 trunk and mask cache; a 24^3
    grid after its pg_scale shrink, 256 rays, 32 + 32 samples) trained from a
    DTU-layout fixture on disk, with the surface-feature term on: 4 steps as
    a superstep window (eager first step under the sync-debug error mode,
    capture, three replays) and as four replays, against 4 eager steps from
    the same state, by `test_graph_replays_match_eager_steps_on_the_card`'s
    rule (losses rtol 1e-3, each parameter within 2e-2 in the L2 norm
    relative to its own, counters and launches equal). Per step the term adds
    two trilinear forwards (its two surface queries) and one backward (the
    cycle check's query takes no gradient)."""
    _need_card()
    import dataclasses
    from poseprobe_tpu_torch.config.presets import dtu_generic
    from poseprobe_tpu_torch.core.tree import tree_leaves
    from poseprobe_tpu_torch.data import loaders, synthetic
    from poseprobe_tpu_torch.train import graphs
    from tools.dtu_fixture import write_dtu
    scene = synthetic.make_synthetic_scene(n_train=3, n_test=6, H=96, W=128, seed=0, texture="noise", n_matches=64)
    root = str(tmp_path / "DTU" / "scan_fixture")
    write_dtu(root, scene)
    cfg = dtu_generic.get_config(datadir=root, selected_id=(0, 1, 2))
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, max_matcher=64),
        object_model=dataclasses.replace(cfg.object_model, num_voxels=8 * 24 ** 3, num_voxels_base=8 * 24 ** 3),
        object_train=dataclasses.replace(cfg.object_train, N_rand=256),
        scene_model=dataclasses.replace(cfg.scene_model, rand_rays=256, sample_intvs=32, sample_intvs_fine=32))
    data = loaders.load_dtu(cfg.data)
    if not data.scene_matches[..., 4].any():        # no OpenCV: the fixture's own packs
        data.obj_matches, data.scene_matches, data.ba_matches = (scene.obj_matches, scene.scene_matches,
                                                                 scene.ba_matches)
    tr = JointTrainer(cfg, data, device="cuda")
    assert fused_mlp.supports(tr.cfg.scene_model) and tr.cfg.object_model.world_size == (24, 24, 24)
    tr.global_step = 1
    assert tr._feature_term_on(tr.phase_flags(1))
    tr.step()
    start = ([t.clone() for t in tr.state_tensors()], tr.generator.get_state(), tr.global_step)

    def run(window: bool):
        for t, c in zip(tr.state_tensors(), start[0]):
            t.copy_(c)
        tr.generator.set_state(start[1])
        tr.global_step = start[2]
        before = graphs._counts()
        grid_before = (fused_mlp.fwd_launches, fused_mlp.bwd_launches, grid_ops.fwd_launches, grid_ops.bwd_launches)
        if window:
            metrics = tr.steps_scan(4)
        else:
            rows = [tr.step() for _ in range(4)]
            metrics = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
        torch.cuda.synchronize()
        launched = [b - a for a, b in zip(before, graphs._counts())]
        per_step = tuple((b - a) / 4 for a, b in zip(grid_before, (fused_mlp.fwd_launches, fused_mlp.bwd_launches,
                                                                   grid_ops.fwd_launches, grid_ops.bwd_launches)))
        params = [t.clone() for n in tr.GROUPS for t in tree_leaves(getattr(tr, f"{n}_params"))]
        counters = [int(tr._step_t)] + [int(getattr(tr, f"opt_{n}_state")["count"]) for n in tr.GROUPS
                                        if getattr(tr, f"opt_{n}_state") is not None]
        return {k: v.cpu() for k, v in metrics.items()}, params, counters, launched, per_step

    eager = run(False)
    assert eager[4] == (1, 1, 5, 4), eager[4]
    assert (eager[0]["feat_rays"] > 0).all() and torch.isfinite(eager[0]["feat_loss"]).all()
    for name, out in (("capture", run(True)), ("replays", run(True))):
        assert tr._graphs.graph is not None, name
        for key in ("loss_total", "feat_loss"):
            np.testing.assert_allclose(out[0][key].numpy(), eager[0][key].numpy(), rtol=1e-3, err_msg=(name, key))
        assert out[2] == eager[2] and out[3] == eager[3] and out[4] == eager[4], (name, out[2:], eager[2:])
        for a, b in zip(out[1], eager[1]):
            assert (a - b).norm().item() <= 2e-2 * max(b.norm().item(), 1e-30), name


# ---------------------------------------------------------------- fused alpha-composite


def _composite_case(N, S, inv_s, dist, seed):
    """Rays walking into a surface, with grazing rays, rays that start inside
    (alpha = 1), masked samples and wholly masked rays; cotangents of the four outputs."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rand = lambda *shape: torch.rand(shape, generator=g, device="cuda")  # noqa: E731
    cos = -rand(N, S) * (rand(N, 1) > 0.1)
    # rays longer than the tile start far enough out to meet the surface anywhere along them
    start = rand(N, 1) * (0.6 if S <= fused_composite.TILE else 0.5 * dist * S) - 0.1
    sdf = start + torch.cumsum(cos * dist, dim=1) + (rand(N, S) - 0.5) * 0.2 * dist
    mask = rand(N, S) > 0.15
    mask[: N // 16] = False
    mask[N // 16: N // 8, S // 2:] = False
    step = (torch.arange(S, device="cuda", dtype=torch.float32) * dist + rand(N, 1) * dist).contiguous()
    randn = lambda *shape: torch.randn(shape, generator=g, device="cuda")  # noqa: E731
    args = (sdf.contiguous(), cos.contiguous(), mask, rand(N, S, 3), step, torch.tensor([inv_s, dist], device="cuda"))
    return args, (randn(N, S), randn(N), randn(N, 3), randn(N))


def _away_from_gate(args, rel=1e-4):
    sdf, cos, mask, _, _, scalars = args
    alpha = torch.where(mask, compositing.neus_alpha_from_sdf(
        torch.ones(1, device="cuda"), scalars[1], sdf, cos[..., None], 1.0 / scalars[0]), 0.0)
    om = torch.clamp(1.0 - alpha.double(), 1e-10, 1.0)
    T = torch.cumprod(torch.cat([torch.ones_like(om[:, :1]), om[:, :-1]], dim=1), dim=1)
    return ~((T / 1e-3 - 1.0).abs() < rel).any(dim=1)


def _offset_view(t, by=1):
    """`t` copied into a buffer `by` elements past its start: a contiguous view
    whose base pointer is off the 16-byte grid (the cooperative load path)."""
    buf = torch.empty(t.numel() + by, dtype=t.dtype, device=t.device)
    buf[by:].copy_(t.reshape(-1))
    return buf[by:].view(t.shape)


def _bulk_bits(names, arrays):
    return sum(1 << j for j, (name, _) in enumerate(arrays) if name in names)


@pytest.mark.cuda
@pytest.mark.parametrize("inv_s", [20.0, 2000.0])
@pytest.mark.parametrize("N,S,offset", [
    (1024, 76, 0), (1024, 113, 0), (1000, 7, 0), (3, 33, 0), (37, 1000, 0), (1, 1, 0),
    (1024, 64, 0),            # S = 2 x 32: a run of 3 (k = ceil(S / 32) made odd)
    (1023, 76, 0),            # N not a multiple of the 4 rays of a block: a ragged last block
    (1021, 113, 0),           # the same, its spans off the 16-byte grid
    (1024, 76, 1),            # every input one element past a 16-byte boundary
    (64, 1024, 0),            # one ray fills the tile
    (64, 1025, 0), (16, 2048, 0),   # past the tile: the ray kernels, the whole ray one stage
    (64, 1312, 0),            # the long-ray early step's K
    (5, 2560, 0),             # the most one stage holds
    (3, 2561, 0), (8, 4096, 0), (4, 8192, 0),   # past it stages of 1280
    (33, 1027, 0),            # rays off the 16-byte grid: each stage's copies chosen apart
    (7, 1500, 1),             # ... and every input one element past a 16-byte boundary
    (5, 4099, 1),             # ... over several stages
])
def test_composite_kernels_match_plain_version(N, S, offset, inv_s):
    _need_card()
    args, cts = _composite_case(N, S, inv_s, 0.0125, seed=N + S)
    chunked = S > fused_composite.TILE
    if offset:
        args = tuple(_offset_view(t, offset) for t in args[:5]) + args[5:]
        cts = tuple(_offset_view(t, offset) for t in cts)
    if offset and not chunked:
        # the plan moves no input of the block's span by a bulk copy, every output by one
        plan = fused_composite.launch_plan(N, S, {n: t.data_ptr() for n, t in zip(
            ("sdf", "cos_term", "mask", "rgb", "step", "ct_w"), args[:5] + cts[:1])} | {
            n: 0 for n in ("d_sdf", "d_cos", "d_rgb", "d_step")}, backward=True)
        assert plan.bulk_full == plan.bulk_last == _bulk_bits(("d_sdf", "d_cos", "d_rgb", "d_step"),
                                                              fused_composite.BWD_ARRAYS)
    counters = ("fwd_chunked_launches", "bwd_chunked_launches") if chunked else ("fwd_launches", "bwd_launches")
    before = [getattr(fused_composite, c) for c in counters]
    outs = fused_composite.composite_fwd(*args)
    grads = fused_composite.composite_bwd(*args, *cts)
    torch.cuda.synchronize()
    assert [getattr(fused_composite, c) for c in counters] == [before[0] + 1, before[1] + 1]
    refs = fused_composite.fused_alpha_composite_plain(*args[:5], args[5][0], args[5][1])
    grefs = fused_composite.composite_bwd_plain(*args, *cts)
    keep = _away_from_gate(args)
    assert int((~keep).sum()) <= 3
    for o, r in zip(outs, refs):
        # past the tile the kernel's transmittance (runs, block scans, stage carries) and the plain cumprod round
        # a product of up to S float32 factors in other orders: S x 2^-24 (the bound on that rounding,
        # relative) of the output's largest value (n_step reaches S * dist, 51 at S = 4096)
        tol = max(1e-5, S * 2.0 ** -24 * float(r[keep].abs().max())) if chunked else 1e-5
        assert torch.isfinite(o).all() and (o[keep] - r[keep]).abs().max() <= tol
    for o, r in zip(grads[:4], grefs[:4]):
        assert torch.isfinite(o).all()
        assert (o[keep] - r[keep]).abs().max() <= 1e-4 * r[keep].abs().max() + 1e-6
    if bool(keep.all()):
        # the scalar gradients are sums over every sample, of either sign
        assert torch.isfinite(grads[4]).all()
        assert (grads[4] - grefs[4]).abs().max() <= 1e-4 * grefs[4].abs().max() + 1e-6 * N * S


@pytest.mark.cuda
def test_composite_bwd_without_cotangents_or_scalar_grads():
    """Absent cotangents (None: the kernel reads nothing for them) give what
    zeros give, bit for bit; `scalar_grads=False` leaves d_scalars out and
    changes no other gradient."""
    _need_card()
    args, cts = _composite_case(1024, 76, 20.0, 0.0125, seed=5)
    full = fused_composite.composite_bwd(*args, cts[0], torch.zeros_like(cts[1]), cts[2], torch.zeros_like(cts[3]))
    part = fused_composite.composite_bwd(*args, cts[0], None, cts[2], None, scalar_grads=False)
    none_w = fused_composite.composite_bwd(*args, None, *cts[1:])
    zero_w = fused_composite.composite_bwd(*args, torch.zeros_like(cts[0]), *cts[1:])
    assert part[4] is None
    for a, b in zip(full[:4], part[:4]):
        assert torch.equal(a, b)
    for a, b in zip(none_w, zero_w):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("N,S", [(64, 1312), (8, 8192)])
def test_ray_kernels_take_each_absent_cotangent(N, S):
    """Past the tile, one stage and several: each cotangent absent in turn
    (None: the kernel reads nothing for it) gives what zeros give, bit for
    bit; `scalar_grads=False` leaves d_scalars out and changes no other
    gradient."""
    _need_card()
    args, cts = _composite_case(N, S, 20.0, 0.0125, seed=6)
    full = fused_composite.composite_bwd(*args, *cts)
    for j in range(4):
        absent = fused_composite.composite_bwd(*args, *(None if i == j else c for i, c in enumerate(cts)))
        zeros = fused_composite.composite_bwd(*args, *(torch.zeros_like(c) if i == j else c for i, c in enumerate(cts)))
        for a, b in zip(absent, zeros):
            assert torch.equal(a, b), j
    part = fused_composite.composite_bwd(*args, *cts, scalar_grads=False)
    assert part[4] is None
    for a, b in zip(full[:4], part[:4]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("N,S", [(1024, 2048), (64, 8192)])
def test_ray_kernels_are_deterministic(N, S):
    """Two runs on the same inputs give the same outputs, gradients and
    per-ray partials of d_inv_s and d_dist, bit for bit (no atomics; sums in
    a fixed order)."""
    _need_card()
    args, cts = _composite_case(N, S, 20.0, 0.0125, seed=7)
    lib, ptr = fused_composite._lib(), fused_composite._ptr
    plan = fused_composite.launch_plan(N, S, {}, backward=True)
    stream = torch.cuda.current_stream().cuda_stream
    runs = []
    for _ in range(2):
        outs = fused_composite.composite_fwd(*args)
        grads = [torch.empty_like(t) for t in (args[0], args[1], args[3], args[4])] + [torch.empty((N, 2), device="cuda")]
        fused_composite._check(lib, fused_composite._launch(lib, True, N, S, plan, [ptr(t) for t in (*args, *cts)],
                                                            [ptr(t) for t in grads], stream), "composite_bwd")
        runs.append([*outs, *grads])
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("N,S", [(64, 76), (16, 1000), (64, 1312), (16, 2048), (8, 8192)])
def test_kernels_follow_transmittance_in_runs(N, S):
    """The kernels' transmittance is `transmittance_in_runs`, bit for bit: at
    inv_s = 0 both cdfs are 0.5 exactly and a live sample's alpha is 1e-5 /
    (0.5 + 1e-5), IEEE's quotient in either, so the kernel and the plain
    version take the same factors; with the mask leaving out samples at
    random, the weights and alphainv equal the model's products exactly."""
    _need_card()
    args, cts = _composite_case(N, S, 0.0, 0.0125, seed=8)
    mask = args[2]
    outs = fused_composite.composite_fwd(*args)
    alpha = torch.where(mask, torch.tensor(1e-5, device="cuda") / (torch.tensor(0.5, device="cuda") + 1e-5), 0.0)
    T, alphainv = fused_composite.transmittance_in_runs(torch.clamp(1.0 - alpha, 1e-10, 1.0))
    assert torch.equal(outs[1], alphainv)
    assert torch.equal(outs[0], torch.where(T > 1e-3, T * alpha, 0.0))
    ref = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha[:, :-1]], dim=1), dim=1)
    assert not torch.equal(T, ref) or S <= 76       # the orders differ: the check above can tell them apart


@pytest.mark.cuda
@pytest.mark.parametrize("N,S", [(1024, 76), (37, 1000), (64, 2048), (4, 8192)])
def test_composite_kernels_replay_in_a_cuda_graph(N, S):
    """Forward and backward captured in one CUDA graph: a replay on new
    inputs copied into the captured ones equals the eager calls bit for bit."""
    _need_card()
    args, cts = _composite_case(N, S, 20.0, 0.0125, seed=3)
    static = [t.clone() for t in (*args, *cts)]
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                 # warm up (builds the library) off the capture
        fused_composite.composite_bwd(*static[:6], *static[6:])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = fused_composite.composite_fwd(*static[:6])
        grads = fused_composite.composite_bwd(*static[:6], *static[6:])
    new_args, new_cts = _composite_case(N, S, 2000.0, 0.0125, seed=4)
    for dst, src in zip(static, (*new_args, *new_cts)):
        dst.copy_(src)
    graph.replay()
    torch.cuda.synchronize()
    eager = (*fused_composite.composite_fwd(*new_args), *fused_composite.composite_bwd(*new_args, *new_cts))
    for a, b in zip((*outs, *grads), eager):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_division_matches_ieee():
    """The composite kernels divide without the IEEE division's slow-path
    branch (`div_rn` in csrc/fused_composite.cu); on normal operands with a
    normal quotient, as the kernels' divisions have them, it equals IEEE
    division (torch's `/` on the card) bit for bit."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(0)
    n = 1 << 20
    u = lambda: torch.rand(n, generator=g, device="cuda")  # noqa: E731
    logu = lambda lo, hi: 10.0 ** (lo + (hi - lo) * u())  # noqa: E731
    p, q_ = u(), u()
    cases = {
        "1 / (1 + e)": (torch.ones(n, device="cuda"), 1.0 + u()),
        "quotient": (p - q_ + 1e-5, p + 1e-5),
        "quotient, small p": (logu(-6, 0) - logu(-6, 0) + 1e-5, logu(-8, 0) + 1e-5),
        "R / o": (torch.randn(n, generator=g, device="cuda") * logu(-3, 3), logu(-10, 0)),
        "n / den^2": (logu(-30, 0), (logu(-5, 0) + 1e-5) ** 2),
        "d_alpha / den": (torch.randn(n, generator=g, device="cuda") * logu(-3, 3), logu(-5, 0) + 1e-5),
    }
    lib = fused_composite._lib()
    for name, (a, b) in cases.items():
        q = torch.empty_like(a)
        fused_composite._check(lib, lib.division_check(a.data_ptr(), b.data_ptr(), q.data_ptr(), n,
                                                       torch.cuda.current_stream().cuda_stream), "division_check")
        ref = a / b
        normal = (a.abs() >= 1.18e-38) & (ref.abs() >= 1.18e-38) & (ref.abs() < 3.4e38)
        assert int(normal.sum()) > n // 2, name
        assert torch.equal(q[normal], ref[normal]), name


@pytest.mark.cuda
def test_fused_composite_autograd_runs_the_backward_kernel():
    """`fused_alpha_composite` on CUDA tensors: forward and backward kernels
    (one launch each), gradients to sdf, cos_term, rgb, step and a tensor
    `inv_s` equal to autograd of the plain version; missing cotangents are zeros."""
    _need_card()
    args, cts = _composite_case(512, 40, 64.0, 0.0125, seed=9)
    sdf, cos, mask, rgb, step, scalars = args
    keep = _away_from_gate(args)
    results = []
    for fn in (fused_composite.fused_alpha_composite, fused_composite.fused_alpha_composite_plain):
        leaves = [t.clone().requires_grad_(True) for t in (sdf, cos, rgb, step)]
        inv_s = torch.tensor(64.0, device="cuda", requires_grad=True)
        before = (fused_composite.fwd_launches, fused_composite.bwd_launches)
        out = fn(leaves[0], leaves[1], mask, leaves[2], leaves[3], inv_s, 0.0125)
        # only two of the four outputs reach the loss
        loss = (out[2][keep] * cts[2][keep]).sum() + (out[1][keep] * cts[1][keep]).sum()
        # `step` reaches neither output: zeros from the kernel, None from the plain version's autograd
        grads = torch.autograd.grad(loss, leaves + [inv_s], allow_unused=True)
        results.append([torch.zeros_like(p) if g is None else g for p, g in zip(leaves + [inv_s], grads)])
        counted = (fused_composite.fwd_launches - before[0], fused_composite.bwd_launches - before[1])
        assert counted == ((1, 1) if fn is fused_composite.fused_alpha_composite else (0, 0))
    for a, b in zip(results[0][:4], results[1][:4]):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max() + 1e-6
    # d_inv_s = sum(d_sdf * sdf + d_cos * cos) / inv_s, terms of either sign: held to
    # 5e-5 of the summed magnitudes of its terms, not of the cancelled result
    d_sdf, d_cos = results[1][0], results[1][1]
    terms = float(((d_sdf * sdf).abs() + (d_cos * cos).abs()).sum()) / 64.0
    assert abs(float(results[0][4]) - float(results[1][4])) <= 5e-5 * terms + 1e-7


@pytest.mark.cuda
def test_composite_wrapper_raises_on_what_the_kernel_does_not_take():
    _need_card()
    args, cts = _composite_case(8, 5, 20.0, 0.0125, seed=0)
    sdf, cos, mask, rgb, step, scalars = args
    with pytest.raises(ValueError, match="cos_term"):
        fused_composite.composite_fwd(sdf, cos.double(), mask, rgb, step, scalars)
    with pytest.raises(ValueError, match="scalars"):
        fused_composite.composite_fwd(sdf, cos, mask, rgb, step, scalars.cpu())
    with pytest.raises(ValueError, match="ct_w"):
        fused_composite.composite_bwd(*args, cts[0][:, :4].contiguous(), *cts[1:])
    none = torch.zeros((1, 0), device="cuda")
    with pytest.raises(ValueError, match="outside"):
        fused_composite.composite_fwd(none, none, none > 0, none[..., None].expand(-1, -1, 3).contiguous(), none,
                                      scalars)
    big = torch.zeros((1, fused_composite.TILE + 1), device="cuda")   # past the tile: taken, by the ray kernel
    big_args = (big, big, big > 0, big[..., None].expand(-1, -1, 3).contiguous(), big, scalars)
    out = fused_composite.composite_fwd(*big_args)
    assert out[0].shape == big.shape
    # a plan the ray kernels cannot take is refused at the launch, not run
    lib, ptr, stream = fused_composite._lib(), fused_composite._ptr, torch.cuda.current_stream().cuda_stream
    plan = fused_composite.launch_plan(1, big.shape[1], {}, backward=False)
    for bad in (dataclasses.replace(plan, warps=plan.warps + 1), dataclasses.replace(plan, smem_bytes=plan.smem_bytes + 16),
                dataclasses.replace(plan, run=3), dataclasses.replace(plan, stage=plan.stage - 1)):
        with pytest.raises(RuntimeError, match="invalid argument"):
            fused_composite._check(lib, fused_composite._launch(lib, False, 1, big.shape[1], bad, [ptr(t) for t in big_args],
                                                                [ptr(t) for t in out], stream), "composite_fwd")
    empty = fused_composite.composite_fwd(*(t[:0].contiguous() for t in args[:5]), scalars)
    assert [tuple(t.shape) for t in empty] == [(0, 5), (0,), (0, 3), (0,)]


@pytest.mark.cuda
@pytest.mark.parametrize("stepsize", [None, 0.02])
def test_early_step_with_the_fused_composite_runs_through_its_kernels(stepsize):
    """With `use_pallas_composite=True` every early step launches the
    composite forward and backward once, and its loss equals the unfused
    step's on the same draws (1e-5 relative). At stepsize 0.02 the chord-bound
    K passes the tile (1308 of 2166 samples at 24^3): the ray kernels."""
    _need_card()
    import dataclasses
    cfg, data = _bench_workload(True, "bfloat16")
    if stepsize is not None:
        cfg = dataclasses.replace(cfg, object_model=dataclasses.replace(cfg.object_model, stepsize=stepsize))
    fused_cfg = dataclasses.replace(cfg, object_model=dataclasses.replace(cfg.object_model, use_pallas_composite=True))
    tr = JointTrainer(fused_cfg, data, device="cuda")
    chunked = tr._mask_k > fused_composite.TILE
    assert chunked == (stepsize is not None)
    tr.global_step = 1
    flags = tr.phase_flags(1)
    draws = tr.sample_draws(flags)
    with torch.no_grad():
        tr.cfg = cfg
        plain, _ = tr.joint_loss(tr.obj_params, tr.scene_params, tr.pose_params, 1, flags, draws)
        tr.cfg = fused_cfg
    counters = ("fwd_chunked_launches", "bwd_chunked_launches") if chunked else ("fwd_launches", "bwd_launches")
    before = [getattr(fused_composite, c) for c in counters]
    m = tr.step(draws)
    assert all(np.isfinite(v.item()) for v in m.values()), m
    assert abs(m["loss_total"].item() - plain.item()) <= 1e-5 * abs(plain.item())
    assert [getattr(fused_composite, c) - n for c, n in zip(counters, before)] == [1, 1]


# ---------------------------------------------------------------- checkpoints and evaluation


def _draws_equal(a, b) -> bool:
    if isinstance(a, dict):
        return set(a) == set(b) and all(_draws_equal(a[k], b[k]) for k in a)
    if a is None or b is None:
        return a is b
    return torch.equal(torch.as_tensor(a), torch.as_tensor(b))


@pytest.mark.cuda
def test_a_state_saved_after_graph_windows_resumes_draw_for_draw(tmp_path):
    """The bench-scale (small) joint trainer runs `fit(8, superstep=4)`: a
    captured step replayed, which advances the device generator's offset on
    the card. Its checkpoint, loaded into a fresh trainer, holds the same
    state tensors bit for bit and the same generator state, draws the same
    next batch, and its next graph window (captured anew: the load rebound
    the state) gives the losses of the run without the break (rtol 1e-3, as
    a graph window against eager steps: the scatters add in a run-dependent
    order)."""
    _need_card()
    from poseprobe_tpu_torch.train import state as state_mod
    a = build_trainer(small=True, device="cuda")
    a.fit(8, superstep=4)
    assert a._graphs.graph is not None
    path = str(tmp_path / "ckpt.npz")
    state_mod.save_checkpoint(path, a, extras=a.host_extras())
    b = build_trainer(small=True, device="cuda")
    state_mod.restore_state(b, state_mod.load_checkpoint(path))
    assert b._graphs.graph is None and b.global_step == a.global_step == 8
    sa, sb = a.state_tensors(), b.state_tensors()
    assert len(sa) == len(sb)
    assert [i for i, (x, y) in enumerate(zip(sa, sb)) if not (x.shape == y.shape and torch.equal(x, y))] == []
    gen_a = a.generator.get_state()
    assert torch.equal(gen_a, b.generator.get_state()), (gen_a.tolist(), b.generator.get_state().tolist())
    flags = a.phase_flags(8)
    da, db = a.sample_draws(flags), b.sample_draws(flags)
    assert _draws_equal(da, db)
    a.generator.set_state(gen_a)
    b.generator.set_state(gen_a)
    wa, wb = a.steps_scan(4), b.steps_scan(4)
    np.testing.assert_allclose(wb["loss_total"].cpu().numpy(), wa["loss_total"].cpu().numpy(), rtol=1e-3)


@pytest.mark.cuda
def test_sdf_volume_and_evaluate_full_launch_the_kernels():
    """`extract_sdf_volume` launches one trilinear forward per 65,536-point
    chunk, `mesh_color_forward` one value+gradient lookup per chunk, and
    `evaluate_full` runs its renders through the trunk forward and its
    test-time iterations through the trunk backward."""
    _need_card()
    from poseprobe_tpu_torch.eval import evaluator
    from poseprobe_tpu_torch.models import object_sdf
    tr = build_trainer(small=True, device="cuda")
    om = tr.cfg.object_model
    before = grid_ops.fwd_launches
    vol = object_sdf.extract_sdf_volume(tr.obj_params, om, resolution=48)
    assert vol.shape == (48, 48, 48) and np.isfinite(vol).all()
    assert grid_ops.fwd_launches - before == 2                 # 110,592 points, 2 chunks
    before = grid_ops.fwd_launches
    rgb = object_sdf.mesh_color_forward(tr.obj_params, om, np.zeros((70_000, 3), np.float32))
    assert rgb.shape == (70_000, 3) and grid_ops.fwd_launches - before == 2 * 2    # value+grad and k0, 2 chunks
    data = tr.data
    before = (fused_mlp.fwd_launches, fused_mlp.bwd_launches)
    res = evaluator.evaluate_full(tr.scene_params, tr.cfg.scene_model, tr.current_pose_host(),
                                  data.poses_gt_w2c[data.i_train], data.images[data.i_test],
                                  data.poses_gt_w2c[data.i_test], data.Ks[data.i_test], (data.near, data.far),
                                  test_iter=2, progress=0.5)
    assert np.isfinite(res["psnr"])
    fwd, bwd = fused_mlp.fwd_launches - before[0], fused_mlp.bwd_launches - before[1]
    assert fwd > 2 * len(data.i_test) and bwd >= 2 * len(data.i_test), (fwd, bwd)


def _window_against_eager(tr):
    """4 eager steps, a superstep window and four replays from one state: the
    losses, counters and launches of the windows against the eager steps'
    (`test_torch_port_superstep.py`'s rule: losses rtol 1e-3, each parameter
    within 2e-2 in the L2 norm relative to its own). Returns the launches of
    the eager steps."""
    from poseprobe_tpu_torch.core.tree import tree_leaves
    from poseprobe_tpu_torch.train import graphs
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
        return losses.cpu(), params, int(tr._step_t), launched

    eager = run(False)
    for name, out in (("capture", run(True)), ("replays", run(True))):
        np.testing.assert_allclose(out[0].numpy(), eager[0].numpy(), rtol=1e-3, err_msg=name)
        assert out[2] == eager[2] and out[3] == eager[3], (name, out[2:], eager[2:])
        for a, b in zip(out[1], eager[1]):
            assert (a - b).norm().item() <= 2e-2 * max(b.norm().item(), 1e-30), name
    return eager[3]


@pytest.mark.cuda
def test_tensorf_step_replays_as_a_cuda_graph():
    """The small bench workload with a TensoRF k0: the early step's lookups
    are the 1-channel SDF ones (3 each way per step) and its graph window
    agrees with eager steps; a doubling through `tensorf_resize` makes the
    captured step stale and the next window captures again."""
    _need_card()
    import dataclasses
    cfg, data = _bench_workload(True, "bfloat16")
    cfg = dataclasses.replace(cfg, object_model=dataclasses.replace(cfg.object_model, grid_type="tensorf"))
    tr = JointTrainer(cfg, data, device="cuda")
    tr.global_step = 1
    before = (grid_ops.fwd_launches, grid_ops.bwd_launches)
    _window_against_eager(tr)
    assert (grid_ops.fwd_launches - before[0]) % 3 == 0 and grid_ops.fwd_launches > before[0]
    graph = tr._graphs.graph
    tr.scale_volume_grid(tr.cfg.object_model.num_voxels * 8)
    tr.refresh_maskcache()
    losses = tr.steps_scan(4)["loss_total"]
    assert tr._graphs.graph is not graph and torch.isfinite(losses).all()


@pytest.mark.cuda
def test_fresh_pixel_depth_consistency_replays_as_a_cuda_graph():
    """The small scene workload at its mid step with the corres weight removed:
    depth consistency draws fresh reference pixels on the device, and the
    graph window agrees with eager steps."""
    _need_card()
    import dataclasses
    from poseprobe_tpu_torch.train.trainer import SceneTrainer
    cfg, data = _bench_workload(True, "bfloat16")
    lw = tuple((k, None if k == "corres" else v) for k, v in cfg.scene_train.loss_weight)
    cfg = dataclasses.replace(cfg, scene_train=dataclasses.replace(cfg.scene_train, loss_weight=lw))
    tr = SceneTrainer(cfg, data, device="cuda")
    tr.global_step = tr.fine_start + 1
    assert "dc_pixels" in tr.sample_draws(tr.phase_flags(tr.global_step))
    before = fused_mlp.fwd_launches
    _window_against_eager(tr)
    assert fused_mlp.fwd_launches > before


@pytest.mark.cuda
def test_superglue_on_the_card_matches_the_cpu(tmp_path, monkeypatch):
    """SuperPoint's maps and SuperGlue's log assignment on the card against
    the same modules on the CPU (seeded random weights; TF32 off), within
    1e-4 of the maps' largest value and 1e-4 abs; keypoints from the CPU's
    heat map ranked on the card equal the CPU's."""
    _need_card()
    from poseprobe_tpu_torch.pose_init import matching, superglue
    from tools.superglue_weights import write
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    write(str(tmp_path))
    monkeypatch.setenv(matching.SUPERGLUE_WEIGHTS_ENV, str(tmp_path))
    (sp, sg), (sp_c, sg_c) = superglue.load_networks("cuda"), superglue.load_networks("cpu")
    g = torch.rand((240, 320), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        (heat, desc), (heat_c, desc_c) = sp.maps(g.cuda()), sp_c.maps(g)
        for a, b in ((heat, heat_c), (desc, desc_c)):
            assert (a.cpu() - b).abs().max() <= 1e-4 * b.abs().max()
        k, s = superglue.nms_topk(heat_c.cuda())
        k_c, s_c = superglue.nms_topk(heat_c)
        assert torch.equal(k.cpu(), k_c) and torch.equal(s.cpu(), s_c)
        d = superglue.sample_descriptors(desc, k)
        z = sg.log_assignment(k, s, d, k.flip(0), s.flip(0), d.flip(0), (240, 320))
        z_c = sg_c.log_assignment(k_c, s_c, d.cpu(), k_c.flip(0), s_c.flip(0), d.cpu().flip(0), (240, 320))
    assert (z.cpu() - z_c).abs().max() <= 1e-4


@pytest.mark.cuda
def test_grid_tp_on_two_ranks_on_the_card(tmp_path):
    """Two gloo ranks on cuda:0 (a (1, 2) mesh): `sample_grid_tp` through the
    trilinear kernels, values and gradients for the slab and the points, and
    `train_step_tp`, against the unsharded plain versions on the CPU (the
    tolerances of tests/test_torch_port_grid_tp.py)."""
    _need_card()
    import torch_port_parallel_ranks as ranks
    from poseprobe_tpu_torch.parallel import object_tp
    rng = np.random.RandomState(0)
    grid = rng.randn(5, 9, 7, 16).astype(np.float32)
    lo, hi = np.array([-1.0, -0.5, -2.0], np.float32), np.array([1.0, 1.5, 2.0], np.float32)
    pts = (rng.uniform(-1.6, 1.6, (97, 3)) * [1.0, 1.0, 2.6]).astype(np.float32)
    iz = (pts[:, 2] + 2.0) / 4.0 * 15
    pts[np.abs(iz - np.round(iz)) < 1e-2, 2] += 0.01      # off the cell seams: one-sided derivatives there
    xs = np.linspace(-0.5, 0.5, 16, dtype=np.float32)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    sdf = (np.maximum.reduce([np.abs(X), np.abs(Y), np.abs(Z)]) - 0.3)[None]
    k0 = rng.randn(6, 16, 16, 16).astype(np.float32) * 0.05
    ang = rng.uniform(-0.25, 0.25, (48, 2)).astype(np.float32)
    rays_o = np.tile(np.array([[0.0, 0.0, -2.0]], np.float32), (48, 1))
    rays_d = np.stack([np.tan(ang[:, 0]), np.tan(ang[:, 1]), np.ones(48, np.float32)], -1)
    tgt, msk = rng.rand(48, 3).astype(np.float32), (np.abs(ang) < 0.15).all(1).astype(np.float32)
    step = dict(near=1.0, far=3.5, n_samples=32, xyz_min=(-0.5,) * 3, xyz_max=(0.5,) * 3, s_val=0.05)
    cases = [("sample", dict(shape=(1, 2), grid=grid, pts=pts, lo=lo, hi=hi, data_sharded=False)),
             ("train_step", dict(shape=(1, 2), sdf=sdf, k0=k0, rays_o=rays_o, rays_d=rays_d, tgt=tgt, msk=msk,
                                 **step))]
    outs = ranks.launch(tmp_path, 2, cases, timeout_s=300, device="cuda")

    g, p = torch.from_numpy(grid).requires_grad_(True), torch.from_numpy(pts).requires_grad_(True)
    ref = grid_ops.trilinear_sample(g, p, torch.from_numpy(lo), torch.from_numpy(hi))
    g_ref, p_ref = torch.autograd.grad(torch.sin(ref).sum(), [g, p])
    t = [torch.from_numpy(a) for a in (sdf, k0, rays_o, rays_d, tgt, msk)]
    ref_sdf, ref_k0, ref_m = object_tp.train_step_tp(*t, mesh=None, **step)
    for r, out in enumerate(outs):
        got, tr = out[0], out[1]
        assert got["launches"][0] > 0 and got["launches"][1] > 0
        np.testing.assert_allclose(got["out"], ref.detach().numpy(), atol=2e-5)
        np.testing.assert_allclose(got["g_grid"], g_ref[..., 8 * r:8 * (r + 1)].numpy(), atol=5e-5)
        np.testing.assert_allclose(got["g_pts"], p_ref.numpy(), atol=5e-5)
        assert abs(tr["metrics"]["loss"] - ref_m["loss"].item()) < 1e-5
        np.testing.assert_allclose(tr["sdf"], ref_sdf[..., 8 * r:8 * (r + 1)].numpy(), rtol=2e-4, atol=2e-6)
        np.testing.assert_allclose(tr["k0"], ref_k0[..., 8 * r:8 * (r + 1)].numpy(), rtol=2e-4, atol=2e-6)
