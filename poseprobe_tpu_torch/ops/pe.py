"""Positional encodings with BARF coarse-to-fine masking.

Port of `poseprobe_tpu/ops/pe.py`. Scene branch (`posenc_scene`): layout
stack([sin, cos], -2) over [C, L] flattened, frequencies 2^k * pi. Object
branch (`posenc_object`): [sin(all C*L), cos(all C*L)], frequencies 2^k
(no pi). Each frequency is weighted by the BARF window at training progress
`progress`.

`posenc_scene_padded` is the scene encoding as the fused trunk takes it: bf16,
zero-padded to the trunk's input width, made by one hand-written kernel each
way on CUDA tensors (`csrc/posenc.cu`) and by the plain chain on CPU ones.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from . import _build

# launches of the `csrc/posenc.cu` kernels; the plain twin does not count
launches = {"posenc_scene_fwd": 0, "posenc_scene_bwd": 0}


def barf_weights(progress, L: int, barf_c2f, device="cuda") -> torch.Tensor:
    """Per-frequency [L] weights in [0, 1] given progress in [0, 1]."""
    if barf_c2f is None:
        return torch.ones(L, dtype=torch.float32, device=device)
    start, end = barf_c2f
    alpha = (progress - start) / (end - start) * L
    k = torch.arange(L, dtype=torch.float32, device=device)
    return (1.0 - torch.cos(torch.clamp(alpha - k, 0.0, 1.0) * math.pi)) / 2.0


def posenc_object(x: torch.Tensor, L: int, progress, barf_c2f) -> torch.Tensor:
    """Object-branch PE: [..., C] -> [..., C + 2*C*L] = [x, masked(sin, cos)]."""
    freqs = 2.0 ** torch.arange(L, dtype=torch.float32, device=x.device)
    spec = (x[..., None] * freqs).reshape(x.shape[:-1] + (-1,))      # [..., C*L]
    enc = torch.cat([torch.sin(spec), torch.cos(spec)], dim=-1)      # [..., 2CL]
    w = barf_weights(progress, L, barf_c2f, device=x.device)
    enc = (enc.reshape(-1, L) * w).reshape(enc.shape)
    return torch.cat([x, enc], dim=-1)


def posenc_scene(x: torch.Tensor, L: int, progress, barf_c2f,
                 include_pi: bool = True, add_raw: bool = True) -> torch.Tensor:
    """[..., C] -> [..., (C +) 2*C*L]."""
    freqs = 2.0 ** torch.arange(L, dtype=torch.float32, device=x.device)
    if include_pi:
        freqs = freqs * math.pi
    spec = x[..., None] * freqs                                    # [..., C, L]
    enc = torch.stack([torch.sin(spec), torch.cos(spec)], dim=-2)  # [..., C, 2, L]
    enc = enc * barf_weights(progress, L, barf_c2f, device=x.device)
    enc = enc.reshape(x.shape[:-1] + (-1,))                        # [..., 2CL]
    if add_raw:
        return torch.cat([x, enc], dim=-1)
    return enc


def posenc_scene_padded_plain(x: torch.Tensor, L: int, progress, barf_c2f, pad: int,
                              include_pi: bool = True, add_raw: bool = True) -> torch.Tensor:
    """The plain twin of `posenc_scene_padded`: `posenc_scene` cast to bf16 and
    zero-padded to `pad` columns."""
    enc = posenc_scene(x, L, progress, barf_c2f, include_pi=include_pi, add_raw=add_raw)
    return F.pad(enc.to(torch.bfloat16), (0, pad - enc.shape[-1]))


@functools.lru_cache(maxsize=None)
def _lib():
    return _build.declare(_build.load("posenc"), posenc_scene_fwd="pppliiiip", posenc_scene_bwd="ppppliiiip")


def _launch(kind: str, *args) -> None:
    lib = _lib()
    _build.check(lib, getattr(lib, kind)(*args), kind)
    launches[kind] += 1


class _PosencScene(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, L, include_pi, add_raw, pad):
        enc = torch.empty((x.shape[0], pad), dtype=torch.bfloat16, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _launch("posenc_scene_fwd", x.data_ptr(), w.data_ptr(), enc.data_ptr(), x.shape[0], L, int(include_pi),
                int(add_raw), pad, stream)
        if ctx.needs_input_grad[0]:
            ctx.save_for_backward(x, w)
        ctx.args = (L, int(include_pi), int(add_raw), pad)
        return enc

    @staticmethod
    def backward(ctx, denc):
        x, w = ctx.saved_tensors
        denc = denc.contiguous()
        dx = torch.empty_like(x)
        _launch("posenc_scene_bwd", x.data_ptr(), denc.data_ptr(), w.data_ptr(), dx.data_ptr(), x.shape[0],
                *ctx.args, torch.cuda.current_stream(x.device).cuda_stream)
        return dx, None, None, None, None, None


def posenc_scene_padded(x: torch.Tensor, L: int, progress, barf_c2f, pad: int,
                        include_pi: bool = True, add_raw: bool = True) -> torch.Tensor:
    """[..., 3] float32 points -> [..., pad] bfloat16: `posenc_scene` rounded to
    bf16 and zero-padded to `pad` columns (a multiple of 8, at most 128), the
    fused trunk's input tile, bit for bit the plain chain's. On CUDA tensors one
    kernel writes it (the BARF weights read on the device, so a captured graph
    follows a `progress` tensor) and one kernel is its backward; the plain twin
    on CPU tensors."""
    D = (3 if add_raw else 0) + 6 * L
    if x.shape[-1] != 3 or x.dtype != torch.float32:
        raise ValueError(f"posenc_scene_padded takes [..., 3] float32 points, got {tuple(x.shape)} {x.dtype}")
    if not (0 <= L and D <= pad <= 128 and pad % 8 == 0):
        raise ValueError(f"posenc_scene_padded pads {D} columns to a multiple of 8 up to 128, got {pad}")
    if not x.is_cuda:
        return posenc_scene_padded_plain(x, L, progress, barf_c2f, pad, include_pi, add_raw)
    w = barf_weights(progress, L, barf_c2f, device=x.device)
    enc = _PosencScene.apply(x.reshape(-1, 3).contiguous(), w, L, include_pi, add_raw, pad)
    return enc.reshape(x.shape[:-1] + (pad,))
