"""Row-major layout kernels: 2-D transposes and a fresh-buffer copy.

Replaces the Pallas TPU kernels of `poseprobe_tpu/ops/pallas/layout.py`:
`transpose2d` ([A, B] -> [B, A]), `transpose_slice` ([V, P] -> [C, V], the
first C of P columns transposed) and `materialize` (identity copy into a
fresh buffer). The CUDA C++ source is `poseprobe_tpu_torch/csrc/layout.cu`
(sm_90a, built with nvcc at first use, bound with ctypes).

On the TPU they moved a grid between the channel-major [C, X, Y, Z] layout
it is stored in and the row-major [V, C] / [V, P] rows that XLA's gather and
scatter-add work on. The port's trilinear sampler (`ops/grid.py`) gathers
from and adds into [C, X, Y, Z] itself, so no path launches `transpose2d` or
`transpose_slice`; `chip_smoke.py` holds both against their twins and times
them. `materialize` stages the
multi-channel scatter's updates under POSEPROBE_SCATTER_BARRIER=1: on the TPU
it was a fusion barrier for XLA; eager PyTorch fuses nothing, so here it is
only the copy.

All three are copies, bound by bytes, and must agree with their plain twins
bit for bit. `torch.Tensor.t().contiguous()` and `clone()` are what they are
measured against, not what they call: on a CUDA tensor a wrapper launches its
kernel or raises; the twin runs only for a tensor on the CPU.
"""
from __future__ import annotations

import functools

import torch

from . import _build
from ._build import check as _check, ptr as _ptr

# launch counts of the kernels; the CPU twins do not count
transpose2d_launches = 0
transpose_slice_launches = 0
materialize_launches = 0


def transpose2d_plain(x: torch.Tensor) -> torch.Tensor:
    return x.t().contiguous()


def transpose_slice_plain(x: torch.Tensor, C: int) -> torch.Tensor:
    return x[:, :C].t().contiguous()


def materialize_plain(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


@functools.lru_cache(maxsize=None)
def _lib():
    return _build.declare(_build.load("layout"), transpose2d="ppllp", transpose_slice="pplllp",
                          materialize="pplp", materialize_design="pplip")


def _check_matrix(name: str, x: torch.Tensor) -> None:
    if x.ndim != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous 2-D float32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")


def _stream(x: torch.Tensor) -> int:
    # the raw handle: a torch.cuda.Stream object per call costs the copy wrapper
    # about as much host time as its launch
    return torch._C._cuda_getCurrentRawStream(x.get_device())


def transpose2d(x: torch.Tensor) -> torch.Tensor:
    """[A, B] -> [B, A], both row-major."""
    global transpose2d_launches
    if not x.is_cuda:
        return transpose2d_plain(x)
    _check_matrix("transpose2d", x)
    A, B = x.shape
    out = torch.empty((B, A), dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    lib = _lib()
    _check(lib, lib.transpose2d(_ptr(x), _ptr(out), A, B, _stream(x)), "transpose2d")
    transpose2d_launches += 1
    return out


def transpose_slice(x: torch.Tensor, C: int) -> torch.Tensor:
    """[V, P] -> [C, V]: the first C of P columns, transposed."""
    global transpose_slice_launches
    if not x.is_cuda:
        return transpose_slice_plain(x, C)
    _check_matrix("transpose_slice", x)
    V, P = x.shape
    if not 0 <= C <= P:
        raise ValueError(f"transpose_slice: C={C} outside [0, {P}]")
    out = torch.empty((C, V), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    _check(lib, lib.transpose_slice(_ptr(x), _ptr(out), V, P, C, _stream(x)), "transpose_slice")
    transpose_slice_launches += 1
    return out


def materialize(x: torch.Tensor) -> torch.Tensor:
    """A copy of contiguous `x` (any rank, any dtype) in a fresh buffer."""
    global materialize_launches
    if not x.is_cuda:
        return materialize_plain(x)
    if not x.is_contiguous():
        raise ValueError("materialize: expected a contiguous tensor")
    out = torch.empty_like(x)
    nbytes = x.numel() * x.element_size()
    if nbytes == 0:
        return out
    if x.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("materialize: expected 16-byte aligned storage")
    lib = _lib()
    _check(lib, lib.materialize(_ptr(x), _ptr(out), nbytes, _stream(x)), "materialize")
    materialize_launches += 1
    return out
