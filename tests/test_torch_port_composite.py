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
    elif kind == "long":
        # rays past the tile that reach the surface between samples ~900 and
        # ~1900: the transmittance crosses the tile's 1024 samples
        cos = f32(-rng.uniform(size=(N, S)))
        sdf = f32(rng.uniform(450, 950, (N, 1)) * DIST + np.cumsum(cos * DIST, axis=1)
                  + rng.uniform(-0.1, 0.1, (N, S)) * DIST)
        mask = rng.uniform(size=(N, S)) > 0.15
        mask[: N // 8] = False                       # a wholly masked ray
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


CASES = [("random", 64, 40), ("march", 96, 76), ("march", 40, 113), ("edges", 64, 24), ("march", 33, 7),
         ("long", 12, 1500), ("long", 8, 2100),   # past the tile: the ray kernels' rays
         ("long", 8, 1312)]                       # ... at the long-ray early step's chord-bound K


def _product_tol(S: int, tol: float) -> float:
    """`tol` for a ray within the tile; past it S x 2^-24, the bound on the
    relative rounding of a product of S float32 factors: the two sides take
    the transmittance's product over 1500-2100 samples in other orders."""
    return tol if S <= TFC.TILE else S * 2.0 ** -24


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
        np.testing.assert_allclose(o.numpy()[keep], np.asarray(r)[keep], rtol=0, atol=_product_tol(S, 1e-6),
                                   err_msg=name)
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
    # any S from 1 up: past the tile the ray kernels take the ray
    long = (torch.tensor(a) for a in _case("march", 3, 1500, seed=0))
    assert TFC._check_inputs(*long, scalars) == (3, 1500)


# ---------------------------------------------------------------- the kernels' plan and scan order


def _plan(N, S, backward, moved=(), by=1, absent=()):
    """The launch plan with every array at a 16-byte aligned address except
    those in `moved` (`by` elements past it) and those in `absent` (None)."""
    arrays = TFC.BWD_ARRAYS if backward else TFC.FWD_ARRAYS
    ptrs = {name: None if name in absent else (1 << 20) + (by * elem if name in moved else 0)
            for name, elem in arrays}
    return TFC.launch_plan(N, S, ptrs, backward)


def _bits(backward, *names):
    arrays = TFC.BWD_ARRAYS if backward else TFC.FWD_ARRAYS
    return sum(1 << j for j, (name, _) in enumerate(arrays) if name in names)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("N,S,R,k,full_off,last_off", [
    (1024, 76, 4, 3, (), ()),                      # the early step: 304 mask bytes a block, all bulk
    (1024, 113, 4, 5, ("mask",), ("mask",)),       # 452 mask bytes: the mask by cooperative loads
    (1024, 64, 4, 3, (), ()),                      # k = 2 made odd
    (1023, 76, 4, 3, (), ("mask",)),               # a last block of 3 rays: 228 mask bytes
    (37, 1000, 1, 33, ("mask",), ("mask",)),       # one ray a block, runs of 33 past the registers
    (1, 1, 4, 1, ("mask",), ("sdf", "cos_term", "mask", "rgb", "step", "w", "ct_w", "d_sdf", "d_cos",
                             "d_rgb", "d_step")),  # one block of one sample: 4-byte spans
])
def test_launch_plan_at_the_main_paths_shapes(N, S, R, k, full_off, last_off, backward):
    """R from S, k = ceil(S / 32) made odd, enough blocks to cover the 132 SMs
    at N = 1024, the tile within the shared memory a block takes without an
    attribute, and the bulk path for each array whose span starts and ends on
    16 bytes (full blocks and the last block apart)."""
    plan = _plan(N, S, backward)
    arrays = TFC.BWD_ARRAYS if backward else TFC.FWD_ARRAYS
    everything = [name for name, _ in arrays]
    assert (plan.rays_per_block, plan.run, plan.blocks) == (R, k, -(-N // R))
    if N == 1024:
        assert plan.blocks >= 132
    assert plan.smem_bytes <= TFC.SMEM_LIMIT
    n = R * S
    regions = (7 if k <= TFC.RUN_IN_REGISTERS else 8) if backward else 6
    assert plan.smem_bytes == 4 * (-(-n // 4) * 4) * regions + -(-n // 16) * 16
    assert plan.bulk_full == _bits(backward, *(x for x in everything if x not in full_off))
    assert plan.bulk_last == _bits(backward, *(x for x in everything if x not in last_off))


def _tiled_plan(N, S, backward):
    """The tiled kernels' plan as it stood before the ray kernels (rays R of
    (4, 2, 1) filling the tile, k = ceil(S / 32) made odd, the tile's bytes),
    for arrays on the 16-byte grid."""
    R = next(r for r in (4, 2, 1) if r * S <= 1024)
    k = -(-S // 32) | 1
    regions = (7 if k <= 5 else 8) if backward else 6
    n = R * S
    blocks = -(-N // R)
    last = N - (blocks - 1) * R
    arrays = TFC.BWD_ARRAYS if backward else TFC.FWD_ARRAYS
    full = sum(1 << j for j, (_, e) in enumerate(arrays) if R * S * e % 16 == 0)
    last_bits = sum(1 << j for j, (_, e) in enumerate(arrays)
                    if (blocks - 1) * R * S * e % 16 == 0 and last * S * e % 16 == 0)
    return TFC.LaunchPlan(R, k, blocks, 4 * (-(-n // 4) * 4) * regions + -(-n // 16) * 16, full, last_bits)


def test_launch_plan_for_every_sample_count():
    """For every S the kernels take: the block's tile fits, the odd runs of the
    32 lanes cover the ray, and runs past RUN_IN_REGISTERS add the backward's
    T region; the plan is the tiled kernels' plan as it stood before the ray
    kernels, field for field, for every S up to the tile."""
    for S in range(1, TFC.TILE + 1):
        for backward in (False, True):
            plan = _plan(1024, S, backward)
            R, k = plan.rays_per_block, plan.run
            assert R * S <= TFC.TILE and plan.smem_bytes <= TFC.SMEM_LIMIT, S
            assert k % 2 == 1 and 32 * k >= S and -(-S // k) <= 32 and k <= 33, S
            assert (k <= TFC.RUN_IN_REGISTERS) == (S <= 160), S
            for N in (1024, 1023, 37):
                assert _plan(N, S, backward) == _tiled_plan(N, S, backward), (N, S, backward)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("N,S,W,stage,stages", [
    (1024, 1024, 0, 0, 0),         # the tile's last S: one warp a block, runs of 33
    (1024, 1025, 7, 1025, 1),      # past it a block of W warps per ray, the whole ray one stage
    (1024, 1312, 9, 1312, 1),      # the long-ray early step's K
    (1024, 2048, 13, 2048, 1),
    (5, 2560, 16, 2560, 1),        # STAGE: the most one stage holds
    (7, 2561, 8, 1280, 3),         # past it stages of STAGE / 2
    (37, 4096, 8, 1280, 4),
    (4, 8192, 8, 1280, 7),
])
def test_launch_plan_at_and_past_the_tile(N, S, W, stage, stages, backward):
    """S = 1024 fills the tile with one ray: one warp a block, runs of 33,
    bulk copies as the spans allow. Past it the ray kernels take a block of W
    warps per ray, runs of RUN_IN_REGISTERS that cover a stage, the whole ray
    one stage up to STAGE samples and stages of STAGE / 2 past it; their
    shared memory is two stage buffers (the next stage lands in one while the
    other is computed) of 25 B a sample, forward and backward alike (each
    float region rounded to 16 bytes; the backward's weight cotangents go
    straight to registers), plus, backward past one stage, a float per stage;
    past 48 KB it takes the kernels' attribute (RAY_SMEM_LIMIT). They choose
    each stage's copies themselves: no bulk bits."""
    plan = _plan(N, S, backward)
    arrays = TFC.BWD_ARRAYS if backward else TFC.FWD_ARRAYS
    if S <= TFC.TILE:
        n = TFC.TILE
        regions = 8 if backward else 6
        assert (plan.rays_per_block, plan.run, plan.blocks, plan.warps, plan.stage) == (1, 33, N, 0, 0)
        assert plan.smem_bytes == 4 * n * regions + n <= TFC.SMEM_LIMIT
        assert plan.bulk_full == plan.bulk_last == _bits(backward, *(name for name, _ in arrays))
        return
    assert (plan.rays_per_block, plan.run, plan.blocks, plan.warps, plan.stage) == (1, 5, N, W, stage)
    assert TFC.ray_geometry(S) == (stage, W, stages)
    assert plan.run <= TFC.RUN_IN_REGISTERS and plan.run % 2 == 1
    assert 32 * (W - 1) * plan.run < stage <= 32 * W * plan.run and W <= TFC.STAGE // (32 * plan.run)
    stage_bytes = 24 * (-(-stage // 4) * 4) + -(-stage // 16) * 16
    carries = -(-stages // 4) * 16 if backward and stages > 1 else 0
    assert plan.smem_bytes == 2 * stage_bytes + carries <= TFC.RAY_SMEM_LIMIT
    if S == 2048:
        assert plan.smem_bytes == 2 * 51200      # the whole ray twice, ~100 KB: past 48 KB, by the attribute
    assert plan.bulk_full == plan.bulk_last == 0


def test_ray_plan_for_sample_counts_past_the_tile():
    """For S past the tile up to 10^5 (every S to 3000, then a stride) and at
    the largest S a plan takes: the runs of the W x 32 lanes cover each stage
    with k <= RUN_IN_REGISTERS, W <= 16, stages of S up to STAGE and of
    STAGE / 2 past it, the shared memory within the attribute's limit and, up
    to S = 2048, small enough for two blocks an SM (228 KB an SM, 1 KB of it
    reserved a block; at the long-ray step's 1312, three); past the largest
    S, the plan raises."""
    for S in [*range(TFC.TILE + 1, 3001), *range(3001, 100_001, 997)]:
        for backward in (False, True):
            plan = _plan(1024, S, backward)
            W, k, stage = plan.warps, plan.run, plan.stage
            assert k == TFC.RUN_IN_REGISTERS and 1 <= W <= 16 and 32 * W * k >= stage, S
            assert stage == (S if S <= TFC.STAGE else TFC.STAGE // 2), S
            assert plan.smem_bytes <= TFC.RAY_SMEM_LIMIT, S
            blocks_per_sm = 228 * 1024 // (plan.smem_bytes + 1024 + 1024)   # dynamic, static, reserved
            if S <= 2048:
                assert blocks_per_sm >= (3 if S <= 1312 else 2), (S, backward, blocks_per_sm)
    largest = (TFC.RAY_SMEM_LIMIT - 2 * 25 * 1280) // 4 * 1280
    assert _plan(1, largest, True).smem_bytes <= TFC.RAY_SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        _plan(1, largest + 4 * 1280 * 4, True)


def _kernel_order(om: np.ndarray, stage: int, W: int, k: int) -> tuple[np.ndarray, np.float32]:
    """One ray's (T, alphainv) walked scalar by scalar in float32 as a block of
    W warps computes it: per stage of `stage` samples, thread t = 32 w + l
    multiplies its run [t k, t k + k) in order; each warp's Hillis-Steele scan
    of its lanes' products (every lane at once: lane l times lane l - off, off
    = 1, 2, 4, 8, 16); the same scan over the W warp totals (lane v warp v's,
    1 past W); a run starts at (the stage's carry x the totals' exclusive
    value at its warp) x its lane's exclusive value, T inside a run serially;
    the carry after the stage is carry x the totals' product (lane 31)."""
    f = np.float32

    def scan(v):                       # inclusive, 32 lanes
        for off in (1, 2, 4, 8, 16):
            v = [v[lane] if lane < off else f(v[lane] * v[lane - off]) for lane in range(32)]
        return v

    S = om.shape[0]
    T = np.empty(S, np.float32)
    carry = f(1.0)
    for s0 in range(0, S, stage):
        n = min(stage, S - s0)
        prods = []
        for t in range(32 * W):
            p = f(1.0)
            for i in range(t * k, min(t * k + k, n)):
                p = f(p * om[s0 + i])
            prods.append(p)
        lanes = [scan(prods[32 * w:32 * w + 32]) for w in range(W)]
        warps = scan([lanes[w][31] for w in range(W)] + [f(1.0)] * (32 - W))
        for w in range(W):
            pre = f(carry * ([f(1.0)] + warps)[w])
            for lane in range(32):
                t = 32 * w + lane
                Tr = f(pre * ([f(1.0)] + lanes[w])[lane])
                for i in range(t * k, min(t * k + k, n)):
                    T[s0 + i] = Tr
                    Tr = f(Tr * om[s0 + i])
        carry = f(carry * warps[31])
    return T, carry


@pytest.mark.parametrize("S", [1024, 1025, 4096, 1312, 2048])
def test_transmittance_in_runs_carries_T_across_chunks(S):
    """The kernels' order of multiplication, bit for bit, against a scalar
    float32 walk of it (`_kernel_order`): within the tile one warp, runs of
    33 (S = 1024); past it the ray kernels' blocks of W warps, runs of 5, the
    warps' totals scanned as the lanes' are and multiplied onto the stage's
    carry, the whole ray one stage up to STAGE (1025: 7 warps; 1312: 9; 2048:
    13) and stages of STAGE / 2 with T carried across them past it (4096:
    four stages of 8 warps); alphainv is the last carry. T stays within 1e-5
    of the cumprod."""
    rng = np.random.default_rng(S)
    om = torch.tensor(np.clip(1.0 - rng.uniform(0, 0.02, (5, S)), 1e-10, 1.0).astype(np.float32))
    T, alphainv = TFC.transmittance_in_runs(om)
    assert T.shape == (5, S)
    if S <= TFC.TILE:
        stage, W, k = S, 1, TFC.run_length(S)
        assert k == 33
    else:
        (stage, W, stages), k = TFC.ray_geometry(S), TFC.RUN_IN_REGISTERS
        assert (stages > 1) == (S > TFC.STAGE) and (W, k) == ((8, 5) if S > TFC.STAGE else (-(-S // 160), 5))
    for r in range(5):
        T_ref, ainv_ref = _kernel_order(om[r].numpy(), stage, W, k)
        np.testing.assert_array_equal(T[r].numpy(), T_ref)
        assert alphainv[r].numpy() == ainv_ref
        for s0 in range(stage, S, stage):          # each stage starts at the carry of the stages before it
            assert T[r, s0].numpy() == _kernel_order(om[r, :s0].numpy(), stage, W, k)[1]
    T_cum = torch.cumprod(torch.cat([torch.ones_like(om[:, :1]), om[:, :-1]], dim=1), dim=1)
    np.testing.assert_allclose(T.numpy(), T_cum.numpy(), rtol=1e-5)


@pytest.mark.parametrize("backward", [False, True])
def test_launch_plan_takes_no_bulk_copy_off_the_16_byte_grid(backward):
    """An array one element past a 16-byte boundary, or an absent cotangent,
    is never a bulk copy; the others keep theirs."""
    moved = ("sdf", "mask", "rgb", "d_rgb")
    plan = _plan(1024, 76, backward, moved=moved, absent=("ct_w",))
    arrays = TFC.BWD_ARRAYS if backward else TFC.FWD_ARRAYS
    kept = [name for name, _ in arrays if name not in moved and name != "ct_w"]
    assert plan.bulk_full == plan.bulk_last == _bits(backward, *kept)
    # four elements on, the f32 arrays are back on the grid; the byte mask is not
    plan = _plan(1024, 76, backward, moved=moved, by=4)
    assert plan.bulk_full == _bits(backward, *(name for name, _ in arrays if name != "mask"))


def _alpha(sdf, cos, mask, inv_s):
    """The plain version's masked alpha, float32."""
    sdf, cos = torch.tensor(sdf), torch.tensor(cos)
    prev_cdf = torch.sigmoid((sdf - cos * DIST * 0.5) * inv_s)
    next_cdf = torch.sigmoid((sdf + cos * DIST * 0.5) * inv_s)
    alpha = torch.clamp((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5), 0.0, 1.0)
    return torch.where(torch.tensor(mask), alpha, 0.0)


@pytest.mark.parametrize("inv_s", [20.0, 2000.0])
@pytest.mark.parametrize("kind,N,S", CASES)
def test_transmittance_in_runs_matches_cumprod_and_jax(kind, N, S, inv_s):
    """The kernels' order of multiplication (run products, a 32-lane scan,
    serial inside the run; `transmittance_in_runs`) against the cumprod of
    the plain version (T within 1e-5 relative) and, as weights and alphainv,
    against the JAX reference (atol 1e-6, as the plain version is held);
    rays within 1e-4 of the gate are left out."""
    sdf, cos, mask, rgb, step = _case(kind, N, S, seed=N + S)
    alpha = _alpha(sdf, cos, mask, inv_s)
    om = torch.clamp(1.0 - alpha, 1e-10, 1.0)
    T, alphainv = TFC.transmittance_in_runs(om)
    T_cum = torch.cumprod(torch.cat([torch.ones_like(om[:, :1]), om[:, :-1]], dim=1), dim=1)
    np.testing.assert_allclose(T.numpy(), T_cum.numpy(), rtol=_product_tol(S, 1e-5), atol=1e-30)
    np.testing.assert_allclose(alphainv.numpy(), (T_cum[:, -1] * om[:, -1]).numpy(), rtol=_product_tol(S, 1e-5),
                               atol=1e-30)
    keep = _away_from_gate(sdf, cos, mask, inv_s, DIST, rel=1e-4)
    assert keep.sum() >= N - 3
    weights = torch.where(T > 1e-3, T * alpha, 0.0)
    ref = FC._jnp_reference(*(jnp.asarray(a) for a in (sdf, cos, mask, rgb, step)), inv_s, DIST)
    np.testing.assert_allclose(weights.numpy()[keep], np.asarray(ref[0])[keep], rtol=0, atol=_product_tol(S, 1e-6))
    np.testing.assert_allclose(alphainv.numpy()[keep], np.asarray(ref[1])[keep], rtol=0, atol=_product_tol(S, 1e-6))


def test_transmittance_in_runs_is_the_scan_it_names():
    """Hand-checked on one ray of S = 7 (k = 1: one sample a lane): run
    products are the samples, T is the exclusive product."""
    om = torch.tensor([[0.5, 0.25, 1.0, 0.5, 0.5, 2.0, 1.0]])
    T, alphainv = TFC.transmittance_in_runs(om)
    assert TFC.run_length(7) == 1 and TFC.run_length(33) == 3 and TFC.run_length(64) == 3
    assert T.tolist() == [[1.0, 0.5, 0.125, 0.125, 0.0625, 0.03125, 0.0625]]
    assert alphainv.tolist() == [0.0625]


def test_cpu_backward_takes_absent_cotangents_as_zeros():
    """On the CPU, as on the card: a None cotangent is zeros; `scalar_grads=False` gives no d_scalars."""
    sdf, cos, mask, rgb, step = (torch.tensor(a) for a in _case("march", 24, 30, seed=8))
    scalars = torch.tensor([30.0, DIST])
    rng = np.random.default_rng(1)
    ct_w, ct_rgbm = (torch.tensor(rng.normal(size=s).astype(np.float32)) for s in ((24, 30), (24, 3)))
    full = TFC.composite_bwd(sdf, cos, mask, rgb, step, scalars, ct_w, torch.zeros(24), ct_rgbm, torch.zeros(24))
    part = TFC.composite_bwd(sdf, cos, mask, rgb, step, scalars, ct_w, None, ct_rgbm, None, scalar_grads=False)
    assert part[4] is None
    for a, b in zip(full[:4], part[:4]):
        assert torch.equal(a, b)


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
