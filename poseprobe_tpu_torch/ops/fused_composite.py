"""Fused NeuS alpha -> transmittance -> composite: Hopper kernels and plain version.

Replaces the Pallas TPU kernel of `poseprobe_tpu/ops/pallas/fused_composite.py`
(`_kernel` / `_pallas_forward`, entered through `fused_alpha_composite`). The
CUDA C++ source is `poseprobe_tpu_torch/csrc/fused_composite.cu` (sm_90a, built
with nvcc at first use, bound with ctypes): a forward kernel and a
hand-written one-pass backward kernel (the TPU side differentiates its jnp
reference instead). A block stages R rays of every array into shared memory
(bulk copies where the spans allow), a warp takes a ray and each lane a run
of k samples; `launch_plan` below chooses R, k and the copy path of each
array, and `transmittance_in_runs` is the kernel's order of multiplication
in plain PyTorch. A ray longer than the tile (S > TILE, any S as on the TPU)
goes to the ray kernels: a block of W warps takes the ray, each lane a run
of RUN_IN_REGISTERS samples, and scans it with a block-wide scan, the whole
ray staged at once up to STAGE samples and in stages of STAGE / 2 past it (T
carried from one stage to the next; the backward runs the stages back,
carrying its suffix sum); blocks are persistent and stage the next ray while
computing one.

Function, per ray of S samples (`fused_alpha_composite_plain` below is the same
in plain PyTorch, built from `compositing.alpha2weights`): NeuS alpha from
(sdf, cos_term, inv_s, dist), masked; the exclusive transmittance T; weights
``T * alpha`` where ``T > 1e-3``; the background transmittance after the last
sample; and the per-ray sums ``sum w * rgb`` and ``sum w * step``.

Gradient conventions, fixed by the plain version and matched by the kernel:
`torch.clamp` passes the gradient at a tie (``1 - alpha == 1.0`` for a masked
sample, ``q == 1.0`` when the next cdf underflows), where `jnp.clip` halves
it; the places where that shows are cut by the mask or carry a vanishing
factor, so both agree with `jax.vjp` of the reference to float32 rounding.
The early-termination gate ``T > 1e-3`` is a step: the kernel's run products
and warp scan, the plain cumprod and the TPU's exp-of-sum differ in T's last
bits, so a sample whose T sits within rounding of 1e-3 may fall on either side.

On a CUDA tensor the wrappers launch the kernels or raise; the plain version
runs only for tensors on the CPU.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from . import _build, compositing
from ._build import check as _check, ptr as _ptr

# the kernels' launch geometry (csrc/fused_composite.cu: TILE, RUN_REGS, SMEM_LIMIT, STAGE, RAY_SMEM_LIMIT)
TILE = 1024               # samples a tiled block stages at most: rays per block x S
RUN_IN_REGISTERS = 5      # runs up to this long keep their per-sample values in registers
SMEM_LIMIT = 48 * 1024    # dynamic shared memory a block takes without an attribute
STAGE = 2560              # past the tile: samples a ray kernel's block stages at once, at most
RAY_SMEM_LIMIT = 225 * 1024   # a ray kernel's dynamic shared memory (its attribute), at most
BULK_ALIGN = 16           # a bulk copy's addresses and size are multiples of this
# the arrays of each kernel in the order of its launch function's pointers (bit j
# of a bulk mask is array j), with their bytes per sample
FWD_ARRAYS = (("sdf", 4), ("cos_term", 4), ("mask", 1), ("rgb", 12), ("step", 4), ("w", 4))
BWD_ARRAYS = (("sdf", 4), ("cos_term", 4), ("mask", 1), ("rgb", 12), ("step", 4), ("ct_w", 4),
              ("d_sdf", 4), ("d_cos", 4), ("d_rgb", 12), ("d_step", 4))

# launch counts of the kernels (the tiled ones, and the ray kernels for S > TILE); the plain
# version does not count
fwd_launches = 0
bwd_launches = 0
fwd_chunked_launches = 0
bwd_chunked_launches = 0


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    rays_per_block: int   # R: a warp per ray (past the tile a block per ray: 1)
    run: int              # k: the samples of a lane's run, odd (the lanes' runs lie on distinct banks)
    blocks: int
    smem_bytes: int       # dynamic shared memory of the block's tile (past it: its stage buffers)
    bulk_full: int        # bit j: array j moves by one bulk copy in a full block
    bulk_last: int        # the same for the last block (ragged when R does not divide N)
    warps: int = 0        # past the tile: the W warps of a ray's block (0: the tiled kernels)
    stage: int = 0        # past the tile: the samples a block stages at once


def run_length(S: int) -> int:
    """k = ceil(S / 32) made odd: lane l owns samples [l k, l k + k)."""
    return -(-S // 32) | 1


def _tile_bytes(n: int, regions: int) -> int:
    """Shared bytes of n samples: `regions` float regions of n rounded up to 4, then the byte mask."""
    return 4 * (-(-n // 4) * 4) * regions + -(-n // 16) * 16


def ray_geometry(S: int) -> tuple[int, int, int]:
    """(stage, W, stages) of the ray kernels for S > TILE: the whole ray in one
    stage up to STAGE samples, else stages of STAGE // 2; W warps whose lanes'
    runs of RUN_IN_REGISTERS samples cover a stage."""
    stage = S if S <= STAGE else STAGE // 2
    return stage, -(-stage // (32 * RUN_IN_REGISTERS)), -(-S // stage)


def launch_plan(N: int, S: int, ptrs: dict, backward: bool) -> LaunchPlan:
    """The kernels' launch plan for an [N, S] call. R: the most rays of (4, 2,
    1) whose R x S samples fit the tile (R = 4 up to S = 256 gives 256 blocks
    at N = 1024, two per SM of 132). `ptrs` maps each name of FWD_ARRAYS or
    BWD_ARRAYS to its data_ptr (None for an absent cotangent); an array takes
    the bulk path in a block whose span of it starts and ends on 16 bytes.
    Past the tile (S > TILE) the ray kernels take a block of W warps per ray
    (`ray_geometry`), runs of RUN_IN_REGISTERS, the shared bytes of two stage
    buffers of the forward's tile layout (the next stage's copies land in one
    while the other is computed; the backward reads its weight cotangents
    straight into registers) and, backward past one stage, a float per stage;
    `blocks` is the number of rays, which the launch function spreads over as
    many persistent blocks as the SMs hold. The kernels choose each stage's
    copy path themselves (no bulk bits here). A plan past RAY_SMEM_LIMIT (S
    past ~5e7) raises."""
    if S > TILE:
        stage, W, stages = ray_geometry(S)
        smem = 2 * _tile_bytes(stage, 6)
        if backward and stages > 1:
            smem += -(-stages // 4) * 16                                  # T at each stage's start
        if smem > RAY_SMEM_LIMIT:
            raise ValueError(f"fused composite: S={S} takes {smem} B of shared memory, past {RAY_SMEM_LIMIT}")
        return LaunchPlan(1, RUN_IN_REGISTERS, N, smem, 0, 0, W, stage)
    arrays = BWD_ARRAYS if backward else FWD_ARRAYS
    R = next(r for r in (4, 2, 1) if r * S <= TILE)
    k = run_length(S)
    regions = (7 if k <= RUN_IN_REGISTERS else 8) if backward else 6   # float regions of the tile
    smem = _tile_bytes(R * S, regions)                                 # ... then the byte mask
    blocks = -(-N // R)
    last = N - (blocks - 1) * R

    def bulk(first_ray: int, rays: int) -> int:
        bits = 0
        for j, (name, elem) in enumerate(arrays):
            p = ptrs.get(name)
            if p is not None and (p + first_ray * S * elem) % BULK_ALIGN == 0 and rays * S * elem % BULK_ALIGN == 0:
                bits |= 1 << j
        return bits
    return LaunchPlan(R, k, blocks, smem, bulk(0, R), bulk((blocks - 1) * R, last))


def _lane_scan(p: torch.Tensor) -> torch.Tensor:
    """The inclusive Hillis-Steele product scan over the last dim of 32 lanes
    (`exclusive_product` before its shift): lane l times lane l - off, off =
    1, 2, 4, 8, 16, every lane at once."""
    for off in (1, 2, 4, 8, 16):
        p = torch.cat([p[..., :off], p[..., off:] * p[..., :-off]], dim=-1)
    return p


def transmittance_in_runs(om: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(T [N, S], alphainv [N]) from o = clamp(1 - alpha) [N, S] in the
    kernels' order of multiplication: lane l's run of k samples multiplied in
    order, a 32-lane Hillis-Steele product scan over the run products (lane l
    times lane l - off, off = 1, 2, 4, 8, 16), T inside a run serially from
    the exclusive scan value; alphainv is the scan's total. Past the tile, the
    ray kernels' order: the ray in the stages of `ray_geometry(S)`; in each,
    thread t = 32 w + l of the block owns the run [t k, t k + k), k =
    RUN_IN_REGISTERS, each warp scans its lanes' run products as above, the
    W warp totals (lane 31's inclusive values) go through the same 32-lane
    scan (1 past W), and warp w's runs start at (carry x the totals' exclusive
    value at w) x the lane's exclusive value; carry (1 at the ray's start)
    takes carry x the totals' inclusive value at lane 31 at the stage's end,
    and alphainv is the last carry. Within the tile that is the one warp's
    scan (1 x a value is that value)."""
    N, S = om.shape
    if S <= TILE:
        stage, W, k = S, 1, run_length(S)
    else:
        (stage, W, _), k = ray_geometry(S), RUN_IN_REGISTERS
    carry = torch.ones_like(om[:, 0])
    parts = []
    for s0 in range(0, S, stage):
        n = min(stage, S - s0)
        runs = torch.nn.functional.pad(om[:, s0:s0 + n], (0, W * 32 * k - n), value=1.0).reshape(N, W, 32, k)
        prod = torch.ones_like(runs[..., 0])
        for i in range(k):
            prod = prod * runs[..., i]
        p = _lane_scan(prod)                                           # [N, W, 32] inclusive
        w = _lane_scan(torch.nn.functional.pad(p[..., 31], (0, 32 - W), value=1.0))   # [N, 32] over warp totals
        excl = lambda x: torch.cat([torch.ones_like(x[..., :1]), x[..., :-1]], dim=-1)  # noqa: E731
        T = (carry[:, None] * excl(w)[:, :W])[..., None] * excl(p)
        carry = carry * w[:, 31]
        Ts = []
        for i in range(k):
            Ts.append(T)
            T = T * runs[..., i]
        parts.append(torch.stack(Ts, dim=-1).reshape(N, W * 32 * k)[:, :n])
    return torch.cat(parts, dim=1), carry


def fused_alpha_composite_plain(sdf, cos_term, mask, rgb, step, inv_s, dist):
    """(weights [N, S], alphainv [N], rgb_marched [N, 3], n_step [N]) in plain
    PyTorch; differentiable by autograd in sdf, cos_term, rgb, step, inv_s, dist."""
    est_next = sdf + cos_term * dist * 0.5
    est_prev = sdf - cos_term * dist * 0.5
    prev_cdf = torch.sigmoid(est_prev * inv_s)
    next_cdf = torch.sigmoid(est_next * inv_s)
    alpha = torch.clamp((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5), 0.0, 1.0)
    alpha = torch.where(mask, alpha, 0.0)
    weights, alphainv = compositing.alpha2weights(alpha)
    return weights, alphainv, (weights[..., None] * rgb).sum(dim=1), (weights * step).sum(dim=1)


def composite_bwd_plain(sdf, cos_term, mask, rgb, step, scalars, ct_w, ct_ainv, ct_rgbm, ct_nstep):
    """Autograd of the plain version: (d_sdf, d_cos, d_rgb, d_step, d_scalars [2]).
    A cotangent that is None counts as zeros."""
    leaves = [t.detach().requires_grad_(True) for t in (sdf, cos_term, rgb, step, scalars)]
    s, c, r, st, sc = leaves
    outs = fused_alpha_composite_plain(s, c, mask, r, st, sc[0], sc[1])
    cts = [torch.zeros_like(o) if ct is None else ct for o, ct in zip(outs, (ct_w, ct_ainv, ct_rgbm, ct_nstep))]
    return torch.autograd.grad(outs, leaves, cts)


@functools.lru_cache(maxsize=None)
def _lib():
    return _build.declare(_build.load("fused_composite"), composite_fwd="pppppp" "iiiiiii" "ppppp",
                          composite_bwd="pppppppppp" "iiiiiii" "pppppp", composite_fwd_ray="pppppp" "iiiiii" "ppppp",
                          composite_bwd_ray="pppppppppp" "iiiiii" "pppppp", division_check="pppip")


def _launch(lib, backward: bool, N: int, S: int, plan: LaunchPlan, inputs: list, outputs: list, stream) -> int:
    """The launch function of `plan` on data pointers (`inputs`: the arrays and
    scalars, then the backward's four cotangents; `outputs`: the outputs, then
    the backward's partials): the tiled kernels within the tile, the ray
    kernels past it. Returns the CUDA error code."""
    if S > TILE:
        fn = lib.composite_bwd_ray if backward else lib.composite_fwd_ray
        return fn(*inputs, N, S, plan.warps, plan.run, plan.stage, plan.smem_bytes, *outputs, stream)
    fn = lib.composite_bwd if backward else lib.composite_fwd
    return fn(*inputs, N, S, plan.rays_per_block, plan.run, plan.bulk_full, plan.bulk_last, plan.smem_bytes,
              *outputs, stream)


def _check_inputs(sdf, cos_term, mask, rgb, step, scalars, **more) -> tuple:
    """(N, S) after checking every tensor given (a cotangent may be None)."""
    N, S = sdf.shape
    if S < 1:
        raise ValueError(f"fused composite: S={S} outside [1, inf)")
    shapes = dict(sdf=(N, S), cos_term=(N, S), mask=(N, S), rgb=(N, S, 3), step=(N, S), scalars=(2,),
                  ct_w=(N, S), ct_ainv=(N,), ct_rgbm=(N, 3), ct_nstep=(N,))
    for name, t in dict(sdf=sdf, cos_term=cos_term, mask=mask, rgb=rgb, step=step, scalars=scalars,
                        **more).items():
        if t is None:
            continue
        want = torch.bool if name == "mask" else torch.float32
        if (t.device != sdf.device or t.dtype != want or tuple(t.shape) != shapes[name]
                or not t.is_contiguous()):
            raise ValueError(f"fused composite: {name} must be a contiguous {want} tensor of shape "
                             f"{shapes[name]} on {sdf.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    return N, S


def composite_fwd(sdf, cos_term, mask, rgb, step, scalars):
    """sdf, cos_term, step [N, S] f32, mask [N, S] bool, rgb [N, S, 3] f32,
    scalars [2] f32 = (inv_s, dist) -> (weights, alphainv, rgb_marched, n_step).
    Kernel on CUDA tensors, plain version on CPU ones."""
    global fwd_launches, fwd_chunked_launches
    if not sdf.is_cuda:
        return fused_alpha_composite_plain(sdf, cos_term, mask, rgb, step, scalars[0], scalars[1])
    N, S = _check_inputs(sdf, cos_term, mask, rgb, step, scalars)
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=sdf.device)  # noqa: E731
    w, ainv, rgbm, nstep = new(N, S), new(N), new(N, 3), new(N)
    if N == 0:
        return w, ainv, rgbm, nstep
    lib = _lib()
    plan = launch_plan(N, S, dict(sdf=_ptr(sdf), cos_term=_ptr(cos_term), mask=_ptr(mask), rgb=_ptr(rgb),
                                  step=_ptr(step), w=_ptr(w)), backward=False)
    stream = torch.cuda.current_stream(sdf.device).cuda_stream
    _check(lib, _launch(lib, False, N, S, plan, [_ptr(t) for t in (sdf, cos_term, mask, rgb, step, scalars)],
                        [_ptr(t) for t in (w, ainv, rgbm, nstep)], stream), "composite_fwd")
    if S > TILE:
        fwd_chunked_launches += 1
    else:
        fwd_launches += 1
    return w, ainv, rgbm, nstep


def composite_bwd(sdf, cos_term, mask, rgb, step, scalars, ct_w, ct_ainv, ct_rgbm, ct_nstep,
                  scalar_grads: bool = True):
    """Backward of `composite_fwd`: (d_sdf, d_cos, d_rgb, d_step, d_scalars [2]).
    The inputs are read again (alpha and T are recomputed); nothing else of the
    forward is kept. A cotangent may be None (zeros, and nothing is read for
    it); with `scalar_grads=False` d_scalars is None and not computed. Kernel
    on CUDA tensors, autograd of the plain version on CPU ones."""
    global bwd_launches, bwd_chunked_launches
    if not sdf.is_cuda:
        grads = composite_bwd_plain(sdf, cos_term, mask, rgb, step, scalars, ct_w, ct_ainv, ct_rgbm, ct_nstep)
        return (*grads[:4], grads[4] if scalar_grads else None)
    N, S = _check_inputs(sdf, cos_term, mask, rgb, step, scalars, ct_w=ct_w, ct_ainv=ct_ainv,
                         ct_rgbm=ct_rgbm, ct_nstep=ct_nstep)
    d_sdf, d_cos, d_rgb, d_step = (torch.empty_like(t) for t in (sdf, cos_term, rgb, step))
    partials = torch.empty((N, 2), dtype=torch.float32, device=sdf.device) if scalar_grads else None
    if N == 0:
        return d_sdf, d_cos, d_rgb, d_step, partials.sum(dim=0) if scalar_grads else None
    lib = _lib()
    plan = launch_plan(N, S, dict(sdf=_ptr(sdf), cos_term=_ptr(cos_term), mask=_ptr(mask), rgb=_ptr(rgb),
                                  step=_ptr(step), ct_w=_ptr(ct_w), d_sdf=_ptr(d_sdf), d_cos=_ptr(d_cos),
                                  d_rgb=_ptr(d_rgb), d_step=_ptr(d_step)), backward=True)
    stream = torch.cuda.current_stream(sdf.device).cuda_stream
    _check(lib, _launch(lib, True, N, S, plan, [_ptr(t) for t in (sdf, cos_term, mask, rgb, step, scalars, ct_w,
                                                                  ct_ainv, ct_rgbm, ct_nstep)],
                        [_ptr(t) for t in (d_sdf, d_cos, d_rgb, d_step, partials)], stream), "composite_bwd")
    if S > TILE:
        bwd_chunked_launches += 1
    else:
        bwd_launches += 1
    # the two scalar gradients: one sum over the per-ray partial sums
    return d_sdf, d_cos, d_rgb, d_step, partials.sum(dim=0) if scalar_grads else None


class _FusedComposite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sdf, cos_term, mask, rgb, step, scalars):
        ctx.save_for_backward(sdf, cos_term, mask, rgb, step, scalars)
        ctx.set_materialize_grads(False)        # an output no loss reaches comes back as None, not zeros
        return composite_fwd(sdf, cos_term, mask, rgb, step, scalars)

    @staticmethod
    def backward(ctx, ct_w, ct_ainv, ct_rgbm, ct_nstep):
        sdf, cos_term, mask, rgb, step, scalars = ctx.saved_tensors
        # the kernel reads nothing for an absent cotangent, and sums no partials for scalars without a gradient
        cts = [None if ct is None else ct.contiguous() for ct in (ct_w, ct_ainv, ct_rgbm, ct_nstep)]
        d_sdf, d_cos, d_rgb, d_step, d_scalars = composite_bwd(sdf, cos_term, mask, rgb, step, scalars, *cts,
                                                               scalar_grads=ctx.needs_input_grad[5])
        return d_sdf, d_cos, None, d_rgb, d_step, d_scalars


def _scalar(v, device) -> torch.Tensor:
    """A float32 0-dim tensor on `device`: a tensor moved there (its gradient
    flows back), a number filled in there (no host-to-device copy)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), v, dtype=torch.float32, device=device)


def fused_alpha_composite(sdf, cos_term, mask, rgb, step, inv_s, dist):
    """(weights [N, S], alphainv [N], rgb_marched [N, 3], n_step [N]).

    sdf, cos_term, step: [N, S]; mask: [N, S] bool; rgb: [N, S, 3]; inv_s and
    dist: numbers or 0-dim tensors (a gradient flows to a tensor). CUDA
    tensors go through the kernels (forward and backward), CPU tensors
    through the plain version.
    """
    if not sdf.is_cuda:
        return fused_alpha_composite_plain(sdf, cos_term, mask, rgb, step, inv_s, dist)
    scalars = torch.stack([_scalar(v, sdf.device) for v in (inv_s, dist)])
    return _FusedComposite.apply(sdf.contiguous(), cos_term.contiguous(), mask.contiguous(),
                                 rgb.contiguous(), step.contiguous(), scalars)
