"""The port's fused alpha-composite held against the JAX package's.

`poseprobe_tpu_torch/ops/fused_composite.py` on the CPU runs its plain
PyTorch version (the CUDA kernels are held against that version on the card,
`tests/test_torch_port_cuda.py` and `chip_smoke.py`). Here the plain version
is held against

* `FC._jnp_reference` (outputs, atol 1e-6) and `jax.vjp` of it (all six input
  gradients: sdf, cos_term, rgb, step within 1e-4 of the largest reference
  gradient; the scalars inv_s, dist within 5e-5 of the summed magnitudes of
  their terms, the sums running in another order),
* the Pallas kernel itself in interpret mode (atol 1e-5, the tolerance of
  `tests/test_pallas.py`: it takes T from exp of a sum of logs),
* and, through `object_sdf.render(use_pallas_composite=True)`, the JAX render
  with converted params (outputs rtol 1e-5 / atol 2e-5, param gradients 1e-4)
  and the port's own unfused render.

Inputs come from numpy seeds. The cases hold what the fused function has to
survive: samples behind the surface (alpha = 1, the transmittance falls to
1e-10 per sample), rays that graze (cos = 0) or leave the surface
(cos > 0: the quotient is negative and clamps to 0), masked samples, wholly
masked rays, and a sharp sigmoid (`inv_s` = 2000, |x * inv_s| far past 88).

The early-termination gate ``T > 1e-3`` is a step function of a float32
running product: rays with a sample whose transmittance lies within 1e-5
(relative) of 1e-3 are left out of a comparison, since the two sides may round
it to either side. No case here loses more than a few rays to that.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseprobe_tpu.models import object_sdf as jobj
from poseprobe_tpu.ops import maskcache as jmc
from poseprobe_tpu.ops.pallas import fused_composite as FC
from poseprobe_tpu_torch.models import object_sdf as tobj
from poseprobe_tpu_torch.ops import compositing as tcomp, fused_composite as TFC
from test_torch_port_object import T, _assert_tree_grads, _object_state, _rays, _scalar

torch.set_num_threads(1)

DIST = 0.0125


def _case(kind: str, N: int, S: int, seed: int):
    """(sdf, cos_term, mask, rgb, step) as numpy float32 / bool."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    rgb = f32(rng.uniform(size=(N, S, 3)))
    step = f32(np.arange(S) * DIST + rng.uniform(size=(N, 1)) * DIST)
    if kind == "random":
        # as tests/test_pallas.py: unstructured values, cos <= 0
        sdf = f32(rng.normal(size=(N, S)) * 0.5)
        cos = f32(-np.abs(rng.normal(size=(N, S))))
        mask = rng.uniform(size=(N, S)) > 0.2
    elif kind == "march":
        # rays walking into a surface: the SDF falls by |cos| * dist per sample
        cos = f32(-rng.uniform(size=(N, S)) * (rng.uniform(size=(N, 1)) > 0.1))   # a tenth graze
        sdf = f32(rng.uniform(-0.1, 0.5, (N, 1)) + np.cumsum(cos * DIST, axis=1)
                  + rng.uniform(-0.1, 0.1, (N, S)) * DIST)
        mask = rng.uniform(size=(N, S)) > 0.15
        mask[: N // 8] = False                       # wholly masked rays
        mask[N // 8: N // 4, S // 2:] = False        # rays that leave the box early
    elif kind == "edges":
        # alpha = 1 (deep inside: both cdfs underflow), alpha clamped to 0
        # (cos > 0), alpha ~ 1e-5 (far outside), one quarter of the rays each,
        # the last quarter mixed
        sdf = f32(rng.uniform(-0.3, 0.3, (N, S)))
        cos = f32(rng.uniform(-1.0, 1.0, (N, S)))
        q = N // 4
        sdf[:q] = f32(-rng.uniform(0.2, 0.5, (q, S)))
        cos[:q] = -1.0
        cos[q:2 * q] = f32(rng.uniform(0.2, 1.0, (q, S)))
        sdf[q:2 * q] = f32(rng.uniform(-1e-3, 1e-3, (q, S)))   # at the surface, where next_cdf > prev_cdf + 1e-5
        sdf[2 * q:3 * q] = f32(rng.uniform(0.3, 0.6, (q, S)))
        mask = rng.uniform(size=(N, S)) > 0.1
    else:
        raise ValueError(kind)
    return sdf, cos, mask, rgb, step


def _away_from_gate(sdf, cos, mask, inv_s, dist, rel=1e-5):
    """Rays none of whose samples has a transmittance within `rel` of 1e-3 (float64 arithmetic)."""
    sig = lambda x: 0.5 * (1.0 + np.tanh(0.5 * x))  # noqa: E731
    sdf, cos = sdf.astype(np.float64), cos.astype(np.float64)
    p, n = sig((sdf - cos * dist * 0.5) * inv_s), sig((sdf + cos * dist * 0.5) * inv_s)
    alpha = np.where(mask, np.clip((p - n + 1e-5) / (p + 1e-5), 0.0, 1.0), 0.0)
    om = np.clip(1.0 - alpha, 1e-10, 1.0)
    Tr = np.cumprod(np.concatenate([np.ones_like(om[:, :1]), om[:, :-1]], axis=1), axis=1)
    return ~(np.abs(Tr / 1e-3 - 1.0) < rel).any(axis=1)


CASES = [("random", 64, 40), ("march", 96, 76), ("march", 40, 113), ("edges", 64, 24), ("march", 33, 7)]


@pytest.mark.parametrize("inv_s", [20.0, 2000.0])
@pytest.mark.parametrize("kind,N,S", CASES)
def test_plain_matches_jnp_reference(kind, N, S, inv_s):
    sdf, cos, mask, rgb, step = _case(kind, N, S, seed=N + S)
    ref = FC._jnp_reference(*(jnp.asarray(a) for a in (sdf, cos, mask, rgb, step)), inv_s, DIST)
    out = TFC.fused_alpha_composite_plain(*(torch.tensor(a) for a in (sdf, cos, mask, rgb, step)),
                                          inv_s, DIST)
    keep = _away_from_gate(sdf, cos, mask, inv_s, DIST)
    assert keep.sum() >= N - 3
    for o, r, name in zip(out, ref, ("weights", "alphainv", "rgb_marched", "n_step")):
        assert np.isfinite(o.numpy()).all(), name
        np.testing.assert_allclose(o.numpy()[keep], np.asarray(r)[keep], rtol=0, atol=1e-6, err_msg=name)
    if kind == "edges":
        # the hard cases are really there: a leaving ray's quotient is negative
        # (alpha = 0 exactly, all the light passes) and, under the sharp
        # sigmoid, both cdfs of a sample behind the surface underflow
        # (alpha = 1, T falls by 1e-10 a sample)
        np.testing.assert_array_equal(out[1].numpy()[N // 4: N // 2], 1.0)
        if inv_s == 2000.0:
            assert float(out[1][: N // 4].max()) <= 1e-10


@pytest.mark.parametrize("inv_s", [20.0, 2000.0])
@pytest.mark.parametrize("kind,N,S", CASES)
def test_plain_gradients_match_jax_vjp(kind, N, S, inv_s):
    """All six input gradients of the plain version against `jax.vjp` of the
    reference, which is what the JAX package's custom VJP runs. Also the
    convention for the clamps: `torch.clamp` passes the gradient at a tie where
    `jnp.clip` halves it, and the cases hold ties of every kind (masked
    samples and clamped-to-zero alphas give 1 - alpha == 1; saturated samples
    give a quotient of exactly 1); each is cut by the mask, by the other
    clamp, or multiplied by a vanishing sigmoid slope, so the two agree."""
    sdf, cos, mask, rgb, step = _case(kind, N, S, seed=2 * N + S)
    rng = np.random.default_rng(S)
    cts = [rng.normal(size=s).astype(np.float32) for s in ((N, S), (N,), (N, 3), (N,))]
    keep = _away_from_gate(sdf, cos, mask, inv_s, DIST)
    assert keep.sum() >= N - 3
    sdf, cos, mask, rgb, step = (a[keep] for a in (sdf, cos, mask, rgb, step))
    cts = [c[keep] for c in cts]

    _, vjp = jax.vjp(lambda s, c, r, st, i, d: FC._jnp_reference(s, c, jnp.asarray(mask), r, st, i, d),
                     *(jnp.asarray(a) for a in (sdf, cos, rgb, step)), jnp.float32(inv_s), jnp.float32(DIST))
    jg = [np.asarray(g) for g in vjp(tuple(jnp.asarray(c) for c in cts))]

    scalars = torch.tensor([inv_s, DIST])
    tg = TFC.composite_bwd_plain(*(torch.tensor(a) for a in (sdf, cos, mask, rgb, step)), scalars,
                                 *(torch.tensor(c) for c in cts))
    tg = [g.numpy() for g in tg[:4]] + [tg[4][0].numpy(), tg[4][1].numpy()]
    for a, b, name in zip(jg[:4], tg[:4], ("d_sdf", "d_cos", "d_rgb", "d_step")):
        assert np.isfinite(b).all(), name
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4 * float(np.abs(a).max()) + 1e-7, err_msg=name)
    # the two scalar gradients are sums over all samples of terms of either
    # sign: d_inv_s = sum(d_sdf * sdf + d_cos * cos) / inv_s and d_dist =
    # sum(d_cos * cos) / dist. They are held to 5e-5 of the sum of the terms'
    # magnitudes, not of the cancelled result: at inv_s = 2000 both packages'
    # float32 values lie ~1e-3 (relative) from the float64 value of the sum,
    # on either side of it.
    terms = {"d_inv_s": (np.abs(jg[0] * sdf) + np.abs(jg[1] * cos)).sum() / inv_s,
             "d_dist": np.abs(jg[1] * cos).sum() / DIST}
    for a, b, name in zip(jg[4:], tg[4:], ("d_inv_s", "d_dist")):
        assert np.isfinite(b)
        np.testing.assert_allclose(b, a, rtol=0, atol=5e-5 * terms[name] + 1e-7, err_msg=name)
    if kind != "edges" or inv_s == 20.0:
        assert np.abs(jg[0]).max() > 0 and np.abs(jg[4]) > 0


@contextlib.contextmanager
def _interpret_pallas():
    from jax.experimental import pallas as pl
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        yield
    finally:
        pl.pallas_call = orig


def _pallas_interpret(sdf, cos, mask, rgb, step, inv_s, dist):
    """The TPU kernel's own code path (the layout work of `FC._fused_forward`
    around `FC._pallas_forward`), run in interpret mode on the CPU."""
    N, S = sdf.shape
    S_pad = -(-S // 8) * 8
    pad = S_pad - S
    nb = N // FC.BLOCK_RAYS
    sdf_t = jnp.pad(sdf, ((0, 0), (0, pad)), constant_values=1.0).T
    cos_t = jnp.pad(cos, ((0, 0), (0, pad))).T
    mask_t = jnp.pad(mask.astype(jnp.float32), ((0, 0), (0, pad))).T
    step_t = jnp.pad(step, ((0, 0), (0, pad))).T
    rgb_t = jnp.moveaxis(jnp.pad(rgb, ((0, 0), (0, pad), (0, 0))), 0, 1).reshape(S_pad, nb, FC.BLOCK_RAYS, 3)
    rgb_t = jnp.swapaxes(rgb_t, 2, 3).reshape(S_pad, nb * 3 * FC.BLOCK_RAYS)
    scalars = jnp.stack([jnp.asarray(inv_s, jnp.float32), jnp.asarray(dist, jnp.float32)])
    with _interpret_pallas():
        w_t, ainv, rgbm, nstep = FC._pallas_forward(sdf_t, cos_t, mask_t, rgb_t, step_t, scalars, S_pad, N)
    rgbm = jnp.moveaxis(rgbm.reshape(nb, 3, FC.BLOCK_RAYS), 1, 2).reshape(N, 3)
    return w_t.T[:, :S], ainv[0], rgbm, nstep[0]


@pytest.mark.parametrize("kind,S,inv_s", [("random", 24, 8.0), ("march", 13, 20.0), ("edges", 16, 2000.0)])
def test_plain_matches_pallas_kernel_interpret(kind, S, inv_s):
    N = FC.BLOCK_RAYS
    sdf, cos, mask, rgb, step = _case(kind, N, S, seed=S)
    ref = _pallas_interpret(*(jnp.asarray(a) for a in (sdf, cos, mask, rgb, step)), inv_s, DIST)
    out = TFC.fused_alpha_composite_plain(*(torch.tensor(a) for a in (sdf, cos, mask, rgb, step)),
                                          inv_s, DIST)
    # exp(sum log) against a running product: T differs by up to ~S ulp, so
    # the rays left out are those within 1e-4 of the gate
    keep = _away_from_gate(sdf, cos, mask, inv_s, DIST, rel=1e-4)
    assert keep.sum() >= N - 3
    for o, r, name in zip(out, ref, ("weights", "alphainv", "rgb_marched", "n_step")):
        np.testing.assert_allclose(o.numpy()[keep], np.asarray(r)[keep], rtol=0, atol=1e-5, err_msg=name)


def test_plain_is_the_unfused_ops():
    """The plain version equals the port's `neus_alpha_from_sdf` + `alpha2weights` chain, bit for bit."""
    sdf, cos, mask, rgb, step = (torch.tensor(a) for a in _case("march", 48, 30, seed=1))
    w, ainv, rgbm, nstep = TFC.fused_alpha_composite_plain(sdf, cos, mask, rgb, step, 50.0, DIST)
    # neus_alpha_from_sdf takes (viewdirs, gradients) and forms -relu(-<v, g>): feed it cos <= 0
    alpha = tcomp.neus_alpha_from_sdf(torch.ones(1), DIST, sdf, cos[..., None], 1.0 / 50.0)
    w2, ainv2 = tcomp.alpha2weights(torch.where(mask, alpha, 0.0))
    assert torch.equal(w, w2) and torch.equal(ainv, ainv2)
    assert torch.equal(rgbm, (w2[..., None] * rgb).sum(1)) and torch.equal(nstep, (w2 * step).sum(1))


def test_wrappers_take_the_plain_version_on_the_cpu():
    """On CPU tensors the wrappers and the autograd entry run the plain
    version and count no launch; a tensor `inv_s` receives its gradient."""
    arrs = [torch.tensor(a) for a in _case("march", 32, 20, seed=4)]
    sdf, cos, mask, rgb, step = arrs
    before = (TFC.fwd_launches, TFC.bwd_launches)
    scalars = torch.tensor([30.0, DIST])
    ref = TFC.fused_alpha_composite_plain(*arrs, 30.0, DIST)
    for o, r in zip(TFC.composite_fwd(*arrs, scalars), ref):
        assert torch.equal(o, r)
    inv_s = torch.tensor(30.0, requires_grad=True)
    sdf_l = sdf.clone().requires_grad_(True)
    out = TFC.fused_alpha_composite(sdf_l, cos, mask, rgb, step, inv_s, DIST)
    for o, r in zip(out, ref):
        assert torch.equal(o.detach(), r)
    cts = [torch.ones_like(o) for o in out]
    g_sdf, g_invs = torch.autograd.grad(out, [sdf_l, inv_s], cts)
    want = TFC.composite_bwd(sdf, cos, mask, rgb, step, scalars, *cts)
    np.testing.assert_allclose(g_sdf.numpy(), want[0].numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(g_invs.item(), want[4][0].item(), rtol=1e-5)
    assert (TFC.fwd_launches, TFC.bwd_launches) == before


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    """The checks in front of the launch (they run before any CUDA call)."""
    sdf, cos, mask, rgb, step = (torch.tensor(a) for a in _case("random", 8, 5, seed=0))
    scalars = torch.tensor([10.0, DIST])
    with pytest.raises(ValueError, match="rgb"):
        TFC._check_inputs(sdf, cos, mask, rgb[:, :, :2].contiguous(), step, scalars)
    with pytest.raises(ValueError, match="mask"):
        TFC._check_inputs(sdf, cos, mask.float(), rgb, step, scalars)
    with pytest.raises(ValueError, match="step"):
        TFC._check_inputs(sdf, cos, mask, rgb, step.t().contiguous().t(), scalars)
    with pytest.raises(ValueError, match="outside"):
        TFC._check_inputs(*(t[:, :0].contiguous() for t in (sdf, cos, mask, rgb, step)), scalars)
    assert TFC._check_inputs(sdf, cos, mask, rgb, step, scalars) == (8, 5)


# ---------------------------------------------------------------- through render


@pytest.mark.parametrize("use_deform", [True, False])
@pytest.mark.parametrize("masked", [None, "all_true_chord_k", "occupancy"])
def test_fused_render_matches_jax(use_deform, masked):
    """`render(use_pallas_composite=True)`: the port against the JAX render
    (whose fused call runs its jnp reference off the TPU, and `jax.vjp` of it
    in the backward), outputs and the gradient to every param."""
    jp, tp, jc, tc = _object_state(seed=2, use_pallas_composite=True)
    o, d, v = _rays(40, seed=11)
    key = jax.random.PRNGKey(3)
    jitter = np.asarray(jax.random.uniform(key, (40, 1)))
    mask_grid, mask_k = None, None
    if masked == "all_true_chord_k":
        mask_grid, mask_k = np.ones(jc.world_size, bool), jc.n_samples - 3
    elif masked == "occupancy":
        mask_grid = np.asarray(jmc.build_mask_grid(jp["sdf_grid"], 0.15, 3))
    kw = dict(use_deform=use_deform, is_train=True, near=0.5, far=8.5, bg=1.0, mask_k=mask_k)

    def jloss(p):
        out = jobj.render(p, jc, jnp.asarray(o), jnp.asarray(d), jnp.asarray(v), jnp.float32(30.0), rng=key,
                          mask_grid=None if mask_grid is None else jnp.asarray(mask_grid), **kw)
        return _scalar(out, jnp), out

    (jl, jout), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    leaves = [x.requires_grad_(True) for x in jax.tree.leaves(tp)]
    tout = tobj.render(tp, tc, T(o), T(d), T(v), 30, jitter=T(jitter),
                       mask_grid=None if mask_grid is None else T(mask_grid), **kw)
    assert set(tout) == set(jout)
    for k in jout:
        np.testing.assert_allclose(tout[k].detach().numpy(), np.asarray(jout[k]), rtol=1e-5, atol=2e-5, err_msg=k)
    tl = _scalar(tout, torch)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    tg = torch.autograd.grad(tl, leaves, allow_unused=True)
    tg = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, tg)]
    _assert_tree_grads(tg, jg)


@pytest.mark.parametrize("s_learn", [False, True])
def test_fused_render_equals_unfused_render(s_learn):
    """The port's fused and unfused renders give the same outputs (1e-6: the
    colour and step sums come out of the fused call) and the same gradients
    (1e-5 of the largest); with `s_learn` the sharpness is a param and its
    gradient arrives through the fused call's `inv_s`."""
    _, tp, _, tc = _object_state(seed=5, s_learn=s_learn)
    import dataclasses
    fc = dataclasses.replace(tc, use_pallas_composite=True)
    o, d, v = _rays(32, seed=7)
    jitter = torch.tensor(np.random.default_rng(0).uniform(size=(32, 1)).astype(np.float32))
    leaves = [x.requires_grad_(True) for x in jax.tree.leaves(tp)]
    outs, grads = [], []
    for cfg in (tc, fc):
        out = tobj.render(tp, cfg, T(o), T(d), T(v), 40, jitter=jitter, near=0.5, far=8.5, bg=1.0)
        g = torch.autograd.grad(_scalar(out, torch), leaves, allow_unused=True)
        outs.append(out)
        grads.append([torch.zeros_like(p) if x is None else x for p, x in zip(leaves, g)])
    for k in outs[0]:
        np.testing.assert_allclose(outs[1][k].detach().numpy(), outs[0][k].detach().numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)
    for a, b in zip(*grads):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-5 * max(float(a.abs().max()), 1e-30))
    g_s = grads[1][[id(x) for x in leaves].index(id(tp["s_val"]))]
    assert (float(g_s.abs().sum()) > 0) is s_learn


def test_fused_branch_needs_fast_color_thres_off():
    """As in the reference, `fast_color_thres > 0` takes the unfused branch
    even with the switch on: the outputs are the unfused render's, bit for bit."""
    _, tp, _, tc = _object_state(seed=6, fast_color_thres=1e-4)
    import dataclasses
    o, d, v = _rays(16, seed=2)
    a = tobj.render(tp, tc, T(o), T(d), T(v), 40, near=0.5, far=8.5)
    b = tobj.render(tp, dataclasses.replace(tc, use_pallas_composite=True), T(o), T(d), T(v), 40,
                    near=0.5, far=8.5)
    for k in a:
        assert torch.equal(a[k], b[k]), k
