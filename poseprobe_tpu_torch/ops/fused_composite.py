"""Fused NeuS alpha -> transmittance -> composite: Hopper kernels and plain version.

Replaces the Pallas TPU kernel of `poseprobe_tpu/ops/pallas/fused_composite.py`
(`_kernel` / `_pallas_forward`, entered through `fused_alpha_composite`). The
CUDA C++ source is `poseprobe_tpu_torch/csrc/fused_composite.cu` (sm_90a, built
with nvcc at first use, bound with ctypes): one warp per ray, a forward kernel
and a hand-written backward kernel (the TPU side differentiates its jnp
reference instead).

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
The early-termination gate ``T > 1e-3`` is a step: the kernel's warp scan, the
plain cumprod and the TPU's exp-of-sum differ in T's last bits, so a sample
whose T sits within rounding of 1e-3 may fall on either side.

On a CUDA tensor the wrappers launch the kernels or raise; the plain version
runs only for tensors on the CPU.
"""
from __future__ import annotations

import functools

import torch

from . import _build, compositing
from ._build import check as _check, ptr as _ptr

MAX_SAMPLES = 1024   # the backward keeps one chunk carry per lane: 32 chunks of 32 samples

# launch counts of the kernels; the plain version does not count
fwd_launches = 0
bwd_launches = 0


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
    """Autograd of the plain version: (d_sdf, d_cos, d_rgb, d_step, d_scalars [2])."""
    leaves = [t.detach().requires_grad_(True) for t in (sdf, cos_term, rgb, step, scalars)]
    s, c, r, st, sc = leaves
    outs = fused_alpha_composite_plain(s, c, mask, r, st, sc[0], sc[1])
    return torch.autograd.grad(outs, leaves, [ct_w, ct_ainv, ct_rgbm, ct_nstep])


@functools.lru_cache(maxsize=None)
def _lib():
    return _build.declare(_build.load("fused_composite"), composite_fwd="ppppppiippppp",
                          composite_bwd="pppppppppp" "ii" "pppppp")


def _check_inputs(sdf, cos_term, mask, rgb, step, scalars, **more) -> tuple:
    N, S = sdf.shape
    if not 1 <= S <= MAX_SAMPLES:
        raise ValueError(f"fused composite: S={S} outside [1, {MAX_SAMPLES}]")
    shapes = dict(sdf=(N, S), cos_term=(N, S), mask=(N, S), rgb=(N, S, 3), step=(N, S), scalars=(2,),
                  ct_w=(N, S), ct_ainv=(N,), ct_rgbm=(N, 3), ct_nstep=(N,))
    for name, t in dict(sdf=sdf, cos_term=cos_term, mask=mask, rgb=rgb, step=step, scalars=scalars,
                        **more).items():
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
    global fwd_launches
    if not sdf.is_cuda:
        return fused_alpha_composite_plain(sdf, cos_term, mask, rgb, step, scalars[0], scalars[1])
    N, S = _check_inputs(sdf, cos_term, mask, rgb, step, scalars)
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=sdf.device)  # noqa: E731
    w, ainv, rgbm, nstep = new(N, S), new(N), new(N, 3), new(N)
    if N == 0:
        return w, ainv, rgbm, nstep
    lib = _lib()
    stream = torch.cuda.current_stream(sdf.device).cuda_stream
    _check(lib, lib.composite_fwd(_ptr(sdf), _ptr(cos_term), _ptr(mask), _ptr(rgb), _ptr(step),
                                  _ptr(scalars), N, S, _ptr(w), _ptr(ainv), _ptr(rgbm), _ptr(nstep),
                                  stream), "composite_fwd")
    fwd_launches += 1
    return w, ainv, rgbm, nstep


def composite_bwd(sdf, cos_term, mask, rgb, step, scalars, ct_w, ct_ainv, ct_rgbm, ct_nstep):
    """Backward of `composite_fwd`: (d_sdf, d_cos, d_rgb, d_step, d_scalars [2]).
    The inputs are read again (alpha and T are recomputed); nothing else of the
    forward is kept. Kernel on CUDA tensors, autograd of the plain version on
    CPU ones."""
    global bwd_launches
    if not sdf.is_cuda:
        return composite_bwd_plain(sdf, cos_term, mask, rgb, step, scalars, ct_w, ct_ainv, ct_rgbm,
                                   ct_nstep)
    N, S = _check_inputs(sdf, cos_term, mask, rgb, step, scalars, ct_w=ct_w, ct_ainv=ct_ainv,
                         ct_rgbm=ct_rgbm, ct_nstep=ct_nstep)
    d_sdf, d_cos, d_rgb, d_step = (torch.empty_like(t) for t in (sdf, cos_term, rgb, step))
    partials = torch.empty((N, 2), dtype=torch.float32, device=sdf.device)
    if N == 0:
        return d_sdf, d_cos, d_rgb, d_step, partials.sum(dim=0)
    lib = _lib()
    stream = torch.cuda.current_stream(sdf.device).cuda_stream
    _check(lib, lib.composite_bwd(_ptr(sdf), _ptr(cos_term), _ptr(mask), _ptr(rgb), _ptr(step),
                                  _ptr(scalars), _ptr(ct_w), _ptr(ct_ainv), _ptr(ct_rgbm),
                                  _ptr(ct_nstep), N, S, _ptr(d_sdf), _ptr(d_cos), _ptr(d_rgb),
                                  _ptr(d_step), _ptr(partials), stream), "composite_bwd")
    bwd_launches += 1
    # the two scalar gradients: one sum over the per-ray partial sums
    return d_sdf, d_cos, d_rgb, d_step, partials.sum(dim=0)


class _FusedComposite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sdf, cos_term, mask, rgb, step, scalars):
        ctx.save_for_backward(sdf, cos_term, mask, rgb, step, scalars)
        return composite_fwd(sdf, cos_term, mask, rgb, step, scalars)

    @staticmethod
    def backward(ctx, ct_w, ct_ainv, ct_rgbm, ct_nstep):
        sdf, cos_term, mask, rgb, step, scalars = ctx.saved_tensors
        N, S = sdf.shape
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=sdf.device)  # noqa: E731
        cts = [zeros(*shape) if ct is None else ct.contiguous()
               for ct, shape in ((ct_w, (N, S)), (ct_ainv, (N,)), (ct_rgbm, (N, 3)), (ct_nstep, (N,)))]
        d_sdf, d_cos, d_rgb, d_step, d_scalars = composite_bwd(sdf, cos_term, mask, rgb, step,
                                                               scalars, *cts)
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
