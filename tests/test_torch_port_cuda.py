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
with sums in another order (the backward adds with atomics): 1e-5 of the
twin's max |value| + 1e-6.
"""
import os

import numpy as np
import pytest
import torch

from poseprobe_tpu_torch.models import scene_nerf
from poseprobe_tpu_torch.ops import fused_mlp, grid as grid_ops, layout, pe
from poseprobe_tpu_torch.train.trainer import build_scene_trainer, build_trainer

torch.set_num_threads(1)

REL_TOL = 2e-2
L, SKIP = 8, 4


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _close(out, ref):
    out, ref = out.float(), ref.float()
    assert (out - ref).abs().max() <= REL_TOL * ref.abs().max()


def _inputs(n, seed=0, n_layers=L, skip=SKIP):
    cfg = scene_nerf.SceneConfig(layers_feat=(256,) * n_layers, skip=(skip,))
    layers = scene_nerf.init_nerf_mlp(torch.Generator().manual_seed(seed), cfg)["feat"]
    layers = [{k: v.cuda() for k, v in la.items()} for la in layers]
    g = torch.Generator(device="cuda").manual_seed(seed)
    points = torch.rand((n, 3), generator=g, device="cuda") * 6.0 - 3.0
    enc = pe.posenc_scene(points, cfg.L_3D, 1.0, cfg.barf_c2f)
    return layers, enc, g


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_layers,skip", [
    (393_216, L, SKIP), (100_003, L, SKIP), (1, L, SKIP),
    (5_000, 2, 1), (5_000, 3, 1), (5_000, 4, 3),     # skip on the last layer
])
def test_trunk_kernels_match_twin(n, n_layers, skip):
    _need_card()
    layers, enc, g = _inputs(n, n_layers=n_layers, skip=skip)
    w, b = fused_mlp.pack_params(layers, skip)
    x = torch.nn.functional.pad(enc.to(torch.bfloat16), (0, fused_mlp.IN_PAD - enc.shape[1])).contiguous()
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
def test_scene_step_runs_through_the_kernels():
    _need_card()
    tr = build_scene_trainer(small=True, device="cuda")
    for start, per_step in ((tr.cfg.object_train.N_iters + 1, (1, 1)), (tr.fine_start + 1, (6, 4))):
        tr.global_step = start
        fused_mlp.fwd_launches = fused_mlp.bwd_launches = 0
        m = tr.step()
        assert all(np.isfinite(v.item()) for v in m.values()), m
        assert (fused_mlp.fwd_launches, fused_mlp.bwd_launches) == per_step


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


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [((884_736, 16), torch.float32), ((100_003, 13), torch.float32),
                                         ((7,), torch.float32), ((3, 5, 7, 11), torch.float32),
                                         ((1_000_003,), torch.uint8), ((4099, 3), torch.bfloat16)])
def test_materialize_kernel_is_bit_exact(shape, dtype):
    _need_card()
    x = (_randn(*shape, seed=2) * 50).to(dtype)
    before = layout.materialize_launches
    out = layout.materialize(x)
    torch.cuda.synchronize()
    assert out.data_ptr() != x.data_ptr() and out.dtype == dtype and torch.equal(out, x)
    assert layout.materialize_launches == before + 1


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
    rows = grid_ops.rows_from_grid(grid)
    gshape = tuple(grid.shape)
    for o, r in zip(grid_ops.trilinear_fwd(rows, pts, lo, hi, gshape, True),
                    grid_ops.trilinear_fwd_plain(rows, pts, lo, hi, gshape, True)):
        _tri_close(o, r)
    for o, r in zip(grid_ops.trilinear_bwd(rows, pts, lo, hi, gshape, ct_v, ct_g),
                    grid_ops.trilinear_bwd_plain(rows, pts, lo, hi, gshape, ct_v, ct_g)):
        _tri_close(o, r)
    with pytest.raises(ValueError):
        grid_ops.trilinear_fwd(rows, pts.double(), lo, hi, gshape, True)
    with pytest.raises(ValueError):
        grid_ops.trilinear_sample(torch.zeros((1, 1, 4, 4), device="cuda"), pts, lo, hi)   # a 1-voxel axis


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
    lookup, the merged 13-channel lookup, the reprojection term's lookup), one
    transpose2d and one transpose_slice (the 13-channel rows); `materialize`
    only under POSEPROBE_SCATTER_BARRIER=1, with the same loss."""
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
    assert tuple(b - a for a, b in zip(before, counts())) == (1, 1, 3, 3, 1, 1, 1)
    before = counts()
    m = tr.step()
    assert all(np.isfinite(v.item()) for v in m.values()), m
    assert tuple(b - a for a, b in zip(before, counts())) == (1, 1, 3, 3, 1, 1, 0)
