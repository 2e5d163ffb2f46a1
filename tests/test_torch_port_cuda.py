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
twin's max |value| + 1e-6. Composite kernels: float32, the transmittance by a
warp scan instead of a cumprod: outputs 1e-5 abs, gradients 1e-4 of the plain
version's largest + 1e-6; rays with a sample whose transmittance lies within
1e-4 (relative) of the early-termination threshold 1e-3 are left out, since
the gate is a step and the two products round differently.
"""
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


# ---------------------------------------------------------------- fused alpha-composite


def _composite_case(N, S, inv_s, dist, seed):
    """Rays walking into a surface, with grazing rays, rays that start inside
    (alpha = 1), masked samples and wholly masked rays; cotangents of the four outputs."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rand = lambda *shape: torch.rand(shape, generator=g, device="cuda")  # noqa: E731
    cos = -rand(N, S) * (rand(N, 1) > 0.1)
    sdf = rand(N, 1) * 0.6 - 0.1 + torch.cumsum(cos * dist, dim=1) + (rand(N, S) - 0.5) * 0.2 * dist
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


@pytest.mark.cuda
@pytest.mark.parametrize("inv_s", [20.0, 2000.0])
@pytest.mark.parametrize("N,S", [(1024, 76), (1024, 113), (1000, 7), (3, 33), (37, 1000), (1, 1)])
def test_composite_kernels_match_plain_version(N, S, inv_s):
    _need_card()
    args, cts = _composite_case(N, S, inv_s, 0.0125, seed=N + S)
    before = (fused_composite.fwd_launches, fused_composite.bwd_launches)
    outs = fused_composite.composite_fwd(*args)
    grads = fused_composite.composite_bwd(*args, *cts)
    torch.cuda.synchronize()
    assert (fused_composite.fwd_launches, fused_composite.bwd_launches) == (before[0] + 1, before[1] + 1)
    refs = fused_composite.fused_alpha_composite_plain(*args[:5], args[5][0], args[5][1])
    grefs = fused_composite.composite_bwd_plain(*args, *cts)
    keep = _away_from_gate(args)
    assert int((~keep).sum()) <= 3
    for o, r in zip(outs, refs):
        assert torch.isfinite(o).all() and (o[keep] - r[keep]).abs().max() <= 1e-5
    for o, r in zip(grads[:4], grefs[:4]):
        assert torch.isfinite(o).all()
        assert (o[keep] - r[keep]).abs().max() <= 1e-4 * r[keep].abs().max() + 1e-6
    if bool(keep.all()):
        # the scalar gradients are sums over every sample, of either sign
        assert torch.isfinite(grads[4]).all()
        assert (grads[4] - grefs[4]).abs().max() <= 1e-4 * grefs[4].abs().max() + 1e-6 * N * S


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
    big = torch.zeros((1, fused_composite.MAX_SAMPLES + 1), device="cuda")
    with pytest.raises(ValueError, match="outside"):
        fused_composite.composite_fwd(big, big, big > 0, big[..., None].expand(-1, -1, 3).contiguous(), big, scalars)
    empty = fused_composite.composite_fwd(*(t[:0].contiguous() for t in args[:5]), scalars)
    assert [tuple(t.shape) for t in empty] == [(0, 5), (0,), (0, 3), (0,)]


@pytest.mark.cuda
def test_early_step_with_the_fused_composite_runs_through_its_kernels():
    """With `use_pallas_composite=True` every early step launches the
    composite forward and backward once, and its loss equals the unfused
    step's on the same draws (1e-5 relative)."""
    _need_card()
    import dataclasses
    cfg, data = _bench_workload(True, "bfloat16")
    fused_cfg = dataclasses.replace(cfg, object_model=dataclasses.replace(cfg.object_model, use_pallas_composite=True))
    tr = JointTrainer(fused_cfg, data, device="cuda")
    tr.global_step = 1
    flags = tr.phase_flags(1)
    draws = tr.sample_draws(flags)
    with torch.no_grad():
        tr.cfg = cfg
        plain, _ = tr.joint_loss(tr.obj_params, tr.scene_params, tr.pose_params, 1, flags, draws)
        tr.cfg = fused_cfg
    before = (fused_composite.fwd_launches, fused_composite.bwd_launches)
    m = tr.step(draws)
    assert all(np.isfinite(v.item()) for v in m.values()), m
    assert abs(m["loss_total"].item() - plain.item()) <= 1e-5 * abs(plain.item())
    assert (fused_composite.fwd_launches - before[0], fused_composite.bwd_launches - before[1]) == (1, 1)
