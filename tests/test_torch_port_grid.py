"""Parity of the port's layout functions, trilinear sampler and grid stack with
the JAX package, at float32 on the CPU.

The layout twins are held against the Pallas kernels in interpret mode and
must be equal bit for bit. The trilinear sampler (on the CPU: the plain
version of the kernels, i.e. the hand-written forward and backward formulas)
is held against the JAX custom-VJP functions, against the JAX plain-autodiff
references and against the port's own autograd twin: values rtol/atol 1e-5;
gradients (d_grid, d_pts) rtol 1e-4 with an atol of 1e-5 of the largest
element (sums over up to thousands of points in another order). Points lie
inside the box, on voxel corners, on the border and outside it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseprobe_tpu.ops import grid as jgrid
from poseprobe_tpu.ops.pallas import layout as jlayout
from poseprobe_tpu_torch.ops import grid as tgrid, layout as tlayout

torch.set_num_threads(1)

LO = np.array([-0.5, -0.4, -0.6], np.float32)
HI = np.array([0.5, 0.6, 0.3], np.float32)


def T(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


# ---------------------------------------------------------------- layout


@pytest.mark.parametrize("shape", [(300, 13), (13, 300), (2500, 16), (70, 45), (1, 7), (64, 64)])
def test_transpose2d_equals_pallas(shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    ref = np.asarray(jlayout.transpose2d(jnp.asarray(x), interpret=True))
    out = tlayout.transpose2d(T(x))
    assert out.is_contiguous() and np.array_equal(out.numpy(), ref)
    assert np.array_equal(tlayout.transpose2d_plain(T(x)).numpy(), ref)


@pytest.mark.parametrize("V,P,C", [(300, 128, 13), (2500, 16, 13), (777, 4, 3), (50, 128, 128), (9, 16, 1)])
def test_transpose_slice_equals_pallas(V, P, C):
    x = np.random.default_rng(1).normal(size=(V, P)).astype(np.float32)
    ref = np.asarray(jlayout.transpose_slice(jnp.asarray(x), C, interpret=True))
    out = tlayout.transpose_slice(T(x), C)
    assert out.is_contiguous() and np.array_equal(out.numpy(), ref)


@pytest.mark.parametrize("shape", [(300, 13), (5, 7, 3), (2049,), (4, 3, 2, 5)])
def test_materialize_equals_pallas(shape):
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    ref = np.asarray(jlayout.materialize(jnp.asarray(x), interpret=True))
    xt = T(x)
    out = tlayout.materialize(xt)
    assert out.data_ptr() != xt.data_ptr() and np.array_equal(out.numpy(), ref)


def test_layout_cpu_twins_do_not_count_launches():
    before = (tlayout.transpose2d_launches, tlayout.transpose_slice_launches, tlayout.materialize_launches)
    x = torch.zeros((8, 4))
    tlayout.transpose2d(x), tlayout.transpose_slice(x, 2), tlayout.materialize(x)
    assert before == (tlayout.transpose2d_launches, tlayout.transpose_slice_launches,
                      tlayout.materialize_launches)


# ---------------------------------------------------------------- trilinear


def _grid_and_points(C, seed=0, size=(6, 7, 5), n=300):
    rng = np.random.default_rng(seed)
    grid = rng.normal(size=(C,) + size).astype(np.float32)
    inside = rng.uniform(LO, HI, (n, 3))
    outside = rng.uniform(LO - 0.3, HI + 0.3, (n // 3, 3))
    # voxel corners (exact integer index coordinates), the far border included
    ijk = np.stack([rng.integers(0, s, 40) for s in size], -1)
    corners = LO + ijk / (np.asarray(size) - 1.0) * (HI - LO)
    border = np.where(rng.random((40, 3)) < 0.5, LO, HI)
    pts = np.concatenate([inside, outside, corners, border, HI[None], LO[None]]).astype(np.float32)
    return grid, pts


def _off_border(pts, size):
    """Rows of `pts` with no index coordinate exactly on 0 or D-1. There the
    JAX plain-autodiff references differentiate `clip` at its bound (half the
    slope), while the custom VJPs, and the port, use the inclusive `inside`
    mask (full slope): the references' d_pts is compared off the border only."""
    i = (pts - LO) / (HI - LO) * (np.asarray(size, np.float32) - 1)
    return ~np.any((i == 0) | (i == np.asarray(size, np.float32) - 1), axis=1)


def _assert_grad(t, j, name, rows=None):
    j, t = np.asarray(j), t.numpy()
    if rows is not None:
        j, t = j[rows], t[rows]
    t = torch.from_numpy(t)
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-4, atol=1e-5 * max(np.abs(j).max(), 1e-30),
                               err_msg=name)


@pytest.mark.parametrize("C", [1, 3, 13])
@pytest.mark.parametrize("jref", ["custom_vjp", "reference"])
def test_trilinear_sample_matches_jax(C, jref):
    grid, pts = _grid_and_points(C, seed=C)
    ct = np.random.default_rng(9).normal(size=(pts.shape[0], C)).astype(np.float32)
    jfn = jgrid.trilinear_sample if jref == "custom_vjp" else jgrid._trilinear_sample_reference
    jout, vjp = jax.vjp(lambda g, p: jfn(g, p, jnp.asarray(LO), jnp.asarray(HI)),
                        jnp.asarray(grid), jnp.asarray(pts))
    jd_grid, jd_pts = vjp(jnp.asarray(ct))
    rows = None if jref == "custom_vjp" else _off_border(pts, grid.shape[1:])
    for tfn in (tgrid.trilinear_sample, tgrid.trilinear_sample_reference):
        g, p = T(grid, True), T(pts, True)
        out = tfn(g, p, T(LO), T(HI))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
        out.backward(T(ct))
        _assert_grad(g.grad, jd_grid, "d_grid")
        _assert_grad(p.grad, jd_pts, "d_pts", rows)


@pytest.mark.parametrize("C", [1, 3, 13])
@pytest.mark.parametrize("jref", ["custom_vjp", "reference"])
def test_trilinear_sample_with_grad_matches_jax(C, jref):
    grid, pts = _grid_and_points(C, seed=10 + C)
    rng = np.random.default_rng(11)
    ct_v = rng.normal(size=(pts.shape[0], C)).astype(np.float32)
    ct_g = rng.normal(size=(pts.shape[0], C, 3)).astype(np.float32)
    jfn = jgrid.trilinear_sample_with_grad if jref == "custom_vjp" else jgrid._trilinear_vg_reference
    jout, vjp = jax.vjp(lambda g, p: jfn(g, p, jnp.asarray(LO), jnp.asarray(HI)),
                        jnp.asarray(grid), jnp.asarray(pts))
    jd_grid, jd_pts = vjp((jnp.asarray(ct_v), jnp.asarray(ct_g)))
    rows = None if jref == "custom_vjp" else _off_border(pts, grid.shape[1:])
    for tfn in (tgrid.trilinear_sample_with_grad, tgrid.trilinear_vg_reference):
        g, p = T(grid, True), T(pts, True)
        val, grad = tfn(g, p, T(LO), T(HI))
        np.testing.assert_allclose(val.detach().numpy(), np.asarray(jout[0]), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(grad.detach().numpy(), np.asarray(jout[1]), rtol=1e-5, atol=1e-4)
        torch.autograd.backward([val, grad], [T(ct_v), T(ct_g)])
        _assert_grad(g.grad, jd_grid, "d_grid")
        _assert_grad(p.grad, jd_pts, "d_pts", rows)


@pytest.mark.parametrize("barrier", ["0", "1"])
@pytest.mark.parametrize("C", [1, 13])
def test_backward_formulas_match_autograd_twin(C, barrier, monkeypatch):
    """The hand-written backward (what the CUDA kernel computes, written in
    PyTorch ops) against autograd through the nested-lerp twin, also with the
    updates passed through `materialize` (POSEPROBE_SCATTER_BARRIER=1)."""
    monkeypatch.setenv("POSEPROBE_SCATTER_BARRIER", barrier)
    grid, pts = _grid_and_points(C, seed=20 + C)
    rng = np.random.default_rng(21)
    ct_v = T(rng.normal(size=(pts.shape[0], C)).astype(np.float32))
    ct_g = T(rng.normal(size=(pts.shape[0], C, 3)).astype(np.float32))
    g, p = T(grid, True), T(pts, True)
    val, grad = tgrid.trilinear_vg_reference(g, p, T(LO), T(HI))
    torch.autograd.backward([val, grad], [ct_v, ct_g])
    fval, fgrad = tgrid.trilinear_fwd_plain(T(grid), T(pts), T(LO), T(HI), True)
    np.testing.assert_allclose(fval.numpy(), val.detach().numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(fgrad.numpy(), grad.detach().numpy(), rtol=1e-5, atol=1e-4)
    d_grid, d_pts = tgrid.trilinear_bwd_plain(T(grid), T(pts), T(LO), T(HI), ct_v, ct_g)
    assert d_grid.shape == grid.shape and d_grid.is_contiguous()
    _assert_grad(d_grid, g.grad.numpy(), "d_grid")
    _assert_grad(d_pts, p.grad.numpy(), "d_pts")
    # a missing cotangent is a zero cotangent
    only_v = tgrid.trilinear_bwd_plain(T(grid), T(pts), T(LO), T(HI), ct_v, None)
    zeros_g = tgrid.trilinear_bwd_plain(T(grid), T(pts), T(LO), T(HI), ct_v, torch.zeros_like(ct_g))
    for a, b in zip(only_v, zeros_g):
        assert torch.equal(a, b)


@pytest.mark.parametrize("with_grad", [False, True])
@pytest.mark.parametrize("C", [1, 12, 13])
def test_plain_versions_match_jax_primitives(C, with_grad):
    """`trilinear_fwd_plain` / `trilinear_bwd_plain` from the [C, X, Y, Z]
    grid (what the kernels compute) against JAX's `_trilinear_value` /
    `_trilinear_vg` and their custom VJPs on the same numpy inputs, with and
    without d_pts, at points inside, on voxel corners, on the far border and
    outside the box."""
    grid, pts = _grid_and_points(C, seed=30 + C)
    rng = np.random.default_rng(31 + C)
    ct_v = rng.normal(size=(pts.shape[0], C)).astype(np.float32)
    ct_g = rng.normal(size=(pts.shape[0], C, 3)).astype(np.float32)
    jfn = jgrid._trilinear_vg if with_grad else jgrid._trilinear_value
    jout, vjp = jax.vjp(lambda g, p: jfn(g, p, jnp.asarray(LO), jnp.asarray(HI)), jnp.asarray(grid), jnp.asarray(pts))
    jd_grid, jd_pts = vjp((jnp.asarray(ct_v), jnp.asarray(ct_g)) if with_grad else jnp.asarray(ct_v))
    val, grad = tgrid.trilinear_fwd_plain(T(grid), T(pts), T(LO), T(HI), with_grad)
    np.testing.assert_allclose(val.numpy(), np.asarray(jout[0] if with_grad else jout), rtol=1e-5, atol=1e-5)
    if with_grad:
        np.testing.assert_allclose(grad.numpy(), np.asarray(jout[1]), rtol=1e-5, atol=1e-4)
    else:
        assert grad is None
    for need_pts in (False, True):
        d_grid, d_pts = tgrid.trilinear_bwd_plain(T(grid), T(pts), T(LO), T(HI), T(ct_v),
                                                  T(ct_g) if with_grad else None, True, need_pts)
        assert d_grid.shape == grid.shape and d_grid.is_contiguous()
        _assert_grad(d_grid, jd_grid, "d_grid")
        if need_pts:
            _assert_grad(d_pts, jd_pts, "d_pts")
        else:
            assert d_pts is None


def _edge_points(size, seed, n=80):
    """Points on multiples of 8 voxels (one voxel either side), on voxel
    corners, on the far faces, outside the box, and all inside one voxel."""
    rng = np.random.default_rng(seed)
    top = np.asarray(size, np.float32) - 1.0
    spread = rng.uniform(0, top, (n, 3))
    eights = np.stack([rng.choice(np.arange(0, s, 8), n) for s in size], -1) + rng.integers(-1, 2, (n, 3))
    eights = np.where(rng.random((n, 3)) < 0.6, np.clip(eights, 0, top), spread)
    corners = np.stack([rng.integers(0, s, n) for s in size], -1)
    far = np.where(rng.random((n, 3)) < 0.5, top, spread)
    one_voxel = np.floor(top / 2) + rng.uniform(0, 1, (n, 3))
    ijk = np.concatenate([eights, corners, far, one_voxel])
    pts = LO + ijk / top * (HI - LO)
    return np.concatenate([pts, rng.uniform(LO - 0.5, HI + 0.5, (n, 3))]).astype(np.float32)


@pytest.mark.parametrize("barrier", ["0", "1"])
@pytest.mark.parametrize("C", [1, 13])
@pytest.mark.parametrize("size", [(5, 6, 4), (9, 7, 8), (2, 2, 2), (17, 17, 17)])
def test_trilinear_edge_points_match_jax(size, C, barrier, monkeypatch):
    """Value, spatial gradient and both VJPs against JAX's custom-VJP
    `trilinear_sample_with_grad` on ragged grids, at the points where cell
    arithmetic is exact or clamped, with and without the staged scatter."""
    monkeypatch.setenv("POSEPROBE_SCATTER_BARRIER", barrier)
    rng = np.random.default_rng(C + sum(size))
    grid = rng.normal(size=(C,) + size).astype(np.float32)
    pts = _edge_points(size, seed=C + 1)
    ct_v = rng.normal(size=(pts.shape[0], C)).astype(np.float32)
    ct_g = rng.normal(size=(pts.shape[0], C, 3)).astype(np.float32)
    jout, vjp = jax.vjp(lambda g, p: jgrid.trilinear_sample_with_grad(g, p, jnp.asarray(LO), jnp.asarray(HI)),
                        jnp.asarray(grid), jnp.asarray(pts))
    jd_grid, jd_pts = vjp((jnp.asarray(ct_v), jnp.asarray(ct_g)))
    g, p = T(grid, True), T(pts, True)
    val, grad = tgrid.trilinear_sample_with_grad(g, p, T(LO), T(HI))
    np.testing.assert_allclose(val.detach().numpy(), np.asarray(jout[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grad.detach().numpy(), np.asarray(jout[1]), rtol=1e-5, atol=1e-4)
    torch.autograd.backward([val, grad], [T(ct_v), T(ct_g)])
    _assert_grad(g.grad, jd_grid, "d_grid")
    _assert_grad(p.grad, jd_pts, "d_pts")


def test_far_border_and_outside_points():
    """u == D-1 gives i0 = D-2 with weight 1; outside points clamp to the
    border and have zero spatial gradient on the clamped axes."""
    grid = np.random.default_rng(3).normal(size=(2, 4, 4, 4)).astype(np.float32)
    pts = np.stack([HI, HI + 1.0, LO - 1.0]).astype(np.float32)
    val, grad = tgrid.trilinear_sample_with_grad(T(grid), T(pts), T(LO), T(HI))
    np.testing.assert_allclose(val[0].numpy(), grid[:, -1, -1, -1], rtol=1e-6)
    np.testing.assert_allclose(val[1].numpy(), grid[:, -1, -1, -1], rtol=1e-6)
    np.testing.assert_allclose(val[2].numpy(), grid[:, 0, 0, 0], rtol=1e-6)
    assert torch.all(grad[1:] == 0) and torch.any(grad[0] != 0)


# ---------------------------------------------------------------- the rest of the grid stack


@pytest.mark.parametrize("src,dst", [((5, 6, 4), (9, 7, 8)), ((8, 8, 8), (5, 5, 5)), ((1, 4, 3), (3, 6, 5))])
def test_resize_trilinear(src, dst):
    grid = np.random.default_rng(4).normal(size=(3,) + src).astype(np.float32)
    ref = np.asarray(jgrid.resize_trilinear(jnp.asarray(grid), dst))
    out = tgrid.resize_trilinear(T(grid), dst)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_total_variation(masked):
    rng = np.random.default_rng(5)
    v = rng.normal(size=(3, 6, 5, 7)).astype(np.float32)
    mask = (rng.random((1, 6, 5, 7)) < 0.7) if masked else None
    jv, jg = jax.value_and_grad(lambda x: jgrid.total_variation(x, None if mask is None else jnp.asarray(mask)))(
        jnp.asarray(v))
    x = T(v, True)
    out = tgrid.total_variation(x, None if mask is None else T(mask))
    out.backward()
    np.testing.assert_allclose(out.item(), float(jv), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-8)


def test_sdf_gradient_grid_and_smooth_grad_tv():
    rng = np.random.default_rng(6)
    sdf = rng.normal(size=(1, 7, 6, 8)).astype(np.float32)
    mask = rng.random((1, 7, 6, 8)) < 0.6
    np.testing.assert_allclose(tgrid.sdf_gradient_grid(T(sdf), 0.03).numpy(),
                               np.asarray(jgrid.sdf_gradient_grid(jnp.asarray(sdf), jnp.asarray(0.03))),
                               rtol=1e-5, atol=1e-6)
    for m in (None, mask):
        def jf(s):
            g = jgrid.sdf_gradient_grid(s, jnp.asarray(0.03))
            return jgrid.smooth_grad_tv(g, jgrid.binomial_kernel_1d(), None if m is None else jnp.asarray(m))
        jv, jg = jax.value_and_grad(jf)(jnp.asarray(sdf))
        s = T(sdf, True)
        out = tgrid.smooth_grad_tv(tgrid.sdf_gradient_grid(s, 0.03), tgrid.binomial_kernel_1d("cpu"),
                                   None if m is None else T(m))
        out.backward()
        np.testing.assert_allclose(out.item(), float(jv), rtol=1e-5)
        np.testing.assert_allclose(s.grad.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-5 * np.abs(jg).max())


@pytest.mark.parametrize("kernel", ["binomial", "gaussian5"])
def test_conv3d_separable_replicate(kernel):
    grid = np.random.default_rng(7).normal(size=(2, 6, 5, 7)).astype(np.float32)
    if kernel == "binomial":
        jk, tk = jgrid.binomial_kernel_1d(), tgrid.binomial_kernel_1d("cpu")
    else:
        jk, tk = jgrid.gaussian_kernel_1d(5, 0.8), tgrid.gaussian_kernel_1d(5, 0.8, "cpu")
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-6)
    ref = np.asarray(jgrid.conv3d_separable_replicate(jnp.asarray(grid), jk))
    np.testing.assert_allclose(tgrid.conv3d_separable_replicate(T(grid), tk).numpy(), ref, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- the kernels' C interfaces


@pytest.mark.parametrize("module,source", [("grid", "trilinear"), ("layout", "layout"),
                                           ("fused_mlp", "fused_trunk"), ("fused_mlp", "trunk_wide"),
                                           ("fused_composite", "fused_composite")])
def test_ctypes_signatures_match_the_c_interfaces(module, source, monkeypatch):
    """Every signature a wrapper declares for ctypes names, argument by
    argument, the C type of the `extern "C"` function in its csrc/ source:
    'p' a pointer, 'i' an int, 'l' a long long. A wrong count or kind would
    only show on the card, as a refused call or a cut pointer."""
    import importlib
    import re
    from pathlib import Path
    from poseprobe_tpu_torch.ops import _build
    declared = {}
    monkeypatch.setattr(_build, "load", lambda name: name)
    monkeypatch.setattr(_build, "declare", lambda lib, **sigs: declared.setdefault(lib, sigs))
    importlib.import_module(f"poseprobe_tpu_torch.ops.{module}")._lib.__wrapped__()
    text = (Path(_build.__file__).resolve().parents[1] / "csrc" / f"{source}.cu").read_text()
    text = text[text.index('extern "C"'):]
    assert declared[source]
    for fn, sig in declared[source].items():
        params = re.search(r"\bint\s+" + fn + r"\(([^)]*)\)", text).group(1).split(",")
        kinds = "".join("p" if "*" in a else "l" if "long long" in a else "i" for a in params)
        assert kinds == sig, fn
