"""Fused scene-NeRF trunk (L x 256 MLP with one skip): Hopper kernels and twin.

Replaces the Pallas TPU kernels of `poseprobe_tpu/ops/pallas/fused_mlp.py`:
`_trunk_fwd_call` (forward) and `_trunk_bwd_call` (backward), entered through
`fused_trunk` with the custom VJP `_trunk_padded`. The CUDA C++ source is
`poseprobe_tpu_torch/csrc/fused_trunk.cu` (sm_90a, built with nvcc at first
use and bound with ctypes).

Function (identical to the TPU kernels' numerics, checkpoint stride 1):
* forward: bf16 operands, f32 accumulation, bias added in f32, ReLU output
  rounded to bf16 between layers; the skip layer reads concat([act, enc]);
  the last layer's columns are reordered to [feat | density]. Outputs feat
  [N, H] bf16, raw density [N] f32 and the L-1 hidden activations
  [L-1, N, H] bf16 that the backward reads instead of recomputing.
* backward: the last layer's ReLU' mask comes from the forward's bf16 feat;
  the others from the stored activations. Each layer's pre-activation
  gradient g is kept in f32 but cast to bf16 for both of its products
  (dx = g W^T and dW = inp^T g); db sums the f32 g. denc is rounded to bf16
  at layer 0 and the skip layer's enc part is added to it as bf16. The
  wrapper rounds dW and db to bf16 before they flow back through the
  master-weight cast, as the TPU wrapper does.

What bounds it on an H100: the 491,264 MACs per point make the forward
~0.39 TFLOP at the mid-phase fine render (393,216 points), ~0.4 ms at the
989 TFLOP/s bf16 peak, while the stored activations are 7 x N x 256 x 2 B
~ 1.4 GB each way, ~0.55 ms of the 3.35 TB/s HBM for the whole forward: the
forward is bound by bytes, the backward (twice the products, the same
activation bytes plus the per-layer g) nearly balanced.

Forward: a block owns 128 points, two consumer warpgroups of 64 points run
`wgmma` m64n256k16 per layer with the activation as A in registers (the
epilogue's bias + ReLU + bf16 of one layer is, in place, the next layer's A
fragment) and the weights as B from a 4-stage ring of [64 inputs x 256
outputs] stages that a producer warp fills by TMA through the chain kernel's
two tensor maps over the packed weights (MN-major for h W: the descriptors'
transpose bit). The producer runs ahead across layers, so no layer starts on
an L2 round trip. Layer 0 and the skip layer's encoding rows take A from the
encoding tile, loaded by TMA. Each layer's bf16 output goes through a
swizzled staging tile to `acts[l]` (or `feat`) by TMA stores that overlap the
next layer's products; the density column is a dot with W_last[:, 256] in
the last epilogue. Each block still streams the 1 MB trunk from L2 (3 GB per
call at 393,216 points).

Backward: blocks carry no sum across each other the way the TPU's sequential
grid does (dW is 2 MB of f32 per 128-point block), so it is two kernels.
* The chain kernel walks the layers backwards for 128 points per block: two
  consumer warpgroups of 64 points run `wgmma` m64nNk16 with g in registers
  (the masked f32 accumulator of one layer, packed to bf16, is the next
  layer's A fragment) and weight tiles from a 4-stage ring that a producer
  warp fills by TMA straight from the packed weights (a row of a packed
  [K, NO] layer is K-major for gx = g W^T; two tensor maps with the 128-byte
  swizzle, encoded per call in C). Another producer warp bulk-copies the
  ReLU' mask tile a layer ahead; the epilogue adds the density column's
  term, masks, sums db and writes g over the mask it read, and per-row bulk
  stores send it to a scratch buffer `gsave` for dW.
* The dW kernel computes dW_l = inp_l^T g_l with `wgmma` m64n256k16 on two
  shared-memory operands (both MN-major), 128 x 256 tiles over slices of the
  points fed by TMA, and takes the last layer's density column from the same
  chunks.
g goes to device memory once and comes back once, and the activations are
read by both kernels: ~6 GB at 393,216 points, ~1.8 ms, is this design's
floor beside the 0.78 ms operations bound. db and dW are summed with f32
atomics in a run-dependent order: results agree with the twin to f32
rounding before the final bf16 rounding, so a dW or db element may differ by
one bf16 ulp between runs.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import _build
from ._build import check as _check, ptr as _ptr

H = 256          # trunk width the kernel is written for
IN_PAD = 64      # encoded input padded to a multiple of 16 (63 -> 64)
DENS_PAD = 128   # last layer: [feat(H) | density | zeros] = H + DENS_PAD columns

# launch counts of the kernels; the CPU twin does not count
fwd_launches = 0
bwd_launches = 0


# ---------------------------------------------------------------------------
# layout


def supports(cfg) -> bool:
    """True when the scene config's trunk fits the kernel: L >= 2 layers all of
    width 256, one skip strictly inside, encoded input at most 64 wide."""
    feat = tuple(cfg.layers_feat)
    return (len(feat) >= 2 and all(d == H for d in feat)
            and len(cfg.skip) == 1 and 0 < cfg.skip[0] < len(feat)
            and cfg.input_3d_dim <= IN_PAD)


def layout(L: int, skip: int, width: int) -> list:
    """Per layer (K, NO, w_offset, b_offset) of the packed weight/bias buffers:
    layer l is a row-major [K, NO] block; K = IN_PAD (l = 0), width + IN_PAD
    (the skip layer), width otherwise; NO = width, or width + DENS_PAD for the
    last layer."""
    out, wo, bo = [], 0, 0
    for l in range(L):
        K = IN_PAD if l == 0 else (width + IN_PAD if l == skip else width)
        NO = width + DENS_PAD if l == L - 1 else width
        out.append((K, NO, wo, bo))
        wo += K * NO
        bo += NO
    return out


def pack_params(feat_layers: list, skip: int):
    """JAX-layout trunk layers ({'w': [in, out], 'b': [out]}) -> packed bf16
    (w_flat, b_flat) in the kernel layout. Differentiable: the gradient of the
    packed buffers flows back to each layer's w and b."""
    L = len(feat_layers)
    width = feat_layers[0]["w"].shape[1]
    ws, bs = [], []
    for l, layer in enumerate(feat_layers):
        w = layer["w"].to(torch.bfloat16)
        b = layer["b"].to(torch.bfloat16)
        if l == 0:
            w = F.pad(w, (0, 0, 0, IN_PAD - w.shape[0]))
        elif l == skip:
            w = F.pad(w, (0, 0, 0, width + IN_PAD - w.shape[0]))
        if l == L - 1:
            # [density | feat] -> [feat | density | zeros]
            w = F.pad(torch.cat([w[:, 1:], w[:, :1]], dim=1), (0, DENS_PAD - 1))
            b = F.pad(torch.cat([b[1:], b[:1]]), (0, DENS_PAD - 1))
        ws.append(w.reshape(-1))
        bs.append(b)
    return torch.cat(ws), torch.cat(bs)


def _width(b: torch.Tensor, L: int) -> int:
    return (b.numel() - DENS_PAD) // L


# ---------------------------------------------------------------------------
# plain PyTorch twin (same roundings, f32 products of bf16 values)


def trunk_fwd_plain(enc, w, b, L: int, skip: int, store_acts: bool = True):
    width = _width(b, L)
    x = enc.float()
    a = x
    acts = []
    for l, (K, NO, wo, bo) in enumerate(layout(L, skip, width)):
        Wl = w[wo:wo + K * NO].view(K, NO).float()
        inp = x if l == 0 else (torch.cat([a, x], dim=1) if l == skip else a)
        pre = inp @ Wl + b[bo:bo + NO].float()
        if l < L - 1:
            a = torch.relu(pre).to(torch.bfloat16)
            if store_acts:
                acts.append(a)
            a = a.float()
        else:
            feat = torch.relu(pre[:, :width]).to(torch.bfloat16)
            dens = pre[:, width].contiguous()
    return feat, dens, (torch.stack(acts) if store_acts else None)


def trunk_bwd_plain(enc, g_feat, g_dens, feat, acts, w, b, L: int, skip: int):
    width = _width(b, L)
    N = enc.shape[0]
    x = enc.float()
    g = torch.cat([torch.where(feat > 0, g_feat.float(), 0.0), g_dens.float()[:, None],
                   x.new_zeros(N, DENS_PAD - 1)], dim=1)
    lay = layout(L, skip, width)
    dws, dbs = [None] * L, [None] * L
    genc = None
    for l in range(L - 1, -1, -1):
        K, NO, wo, bo = lay[l]
        Wl = w[wo:wo + K * NO].view(K, NO).float()
        a_prev = acts[l - 1].float() if l > 0 else None
        inp = x if l == 0 else (torch.cat([a_prev, x], dim=1) if l == skip else a_prev)
        gb = g.to(torch.bfloat16).float()
        dws[l] = (inp.t() @ gb).reshape(-1)
        dbs[l] = g.sum(0)
        gx = gb @ Wl.t()
        if l == 0:
            denc = gx.to(torch.bfloat16)
        elif l == skip:
            genc = gx[:, width:]
            g = torch.where(a_prev > 0, gx[:, :width], 0.0)
        else:
            g = torch.where(a_prev > 0, gx, 0.0)
    if genc is not None:
        denc = (denc.float() + genc.to(torch.bfloat16).float()).to(torch.bfloat16)
    return denc, torch.cat(dws), torch.cat(dbs)


# ---------------------------------------------------------------------------
# kernel binding (built and loaded by `_build`)


@functools.lru_cache(maxsize=None)
def _lib():
    return _build.declare(_build.load("fused_trunk"), trunk_fwd="ppppppiiip",
                          trunk_bwd_chain="ppppppppiiip", trunk_bwd_dw="pppppiiip")


def _check_inputs(L: int, skip: int, w, b, **tensors) -> None:
    dev = w.device
    if not (2 <= L and 0 < skip < L):
        raise ValueError(f"trunk kernel needs L >= 2 and 0 < skip < L, got L={L} skip={skip}")
    if _width(b, L) != H:
        raise ValueError(f"trunk kernel is built for width {H}, got {_width(b, L)}")
    lay = layout(L, skip, H)
    if w.numel() != lay[-1][2] + lay[-1][0] * lay[-1][1] or b.numel() != L * H + DENS_PAD:
        raise ValueError("packed trunk weights do not match the layout")
    for name, t in dict(tensors, w=w, b=b).items():
        # the kernels' tensor maps and 16-byte accesses need 16-byte aligned bases
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: expected a contiguous, 16-byte aligned tensor on {dev}")


def trunk_fwd(enc, w, b, L: int, skip: int, store_acts: bool = True):
    """enc [N, IN_PAD] bf16, packed w/b bf16 -> (feat [N, H] bf16, dens [N] f32,
    acts [L-1, N, H] bf16 or None). Kernel on CUDA tensors, twin on CPU ones."""
    global fwd_launches
    if not enc.is_cuda:
        return trunk_fwd_plain(enc, w, b, L, skip, store_acts)
    _check_inputs(L, skip, w, b, enc=enc)
    N = enc.shape[0]
    if enc.shape != (N, IN_PAD) or {enc.dtype, w.dtype, b.dtype} != {torch.bfloat16}:
        raise ValueError("trunk_fwd expects enc [N, 64], w and b in bfloat16")
    feat = torch.empty((N, H), dtype=torch.bfloat16, device=enc.device)
    dens = torch.empty(N, dtype=torch.float32, device=enc.device)
    acts = (torch.empty((L - 1, N, H), dtype=torch.bfloat16, device=enc.device)
            if store_acts else None)
    if N == 0:
        return feat, dens, acts
    lib = _lib()
    stream = torch.cuda.current_stream(enc.device).cuda_stream
    _check(lib, lib.trunk_fwd(_ptr(enc), _ptr(w), _ptr(b), _ptr(feat), _ptr(dens), _ptr(acts),
                              N, L, skip, stream), "trunk_fwd")
    fwd_launches += 1
    return feat, dens, acts


def trunk_bwd(enc, g_feat, g_dens, feat, acts, w, b, L: int, skip: int):
    """Backward of `trunk_fwd`: g_feat [N, H] bf16, g_dens [N] bf16 ->
    (denc [N, IN_PAD] bf16, dw f32 packed, db f32 packed). Kernels on CUDA
    tensors, twin on CPU ones."""
    global bwd_launches
    if not enc.is_cuda:
        return trunk_bwd_plain(enc, g_feat, g_dens, feat, acts, w, b, L, skip)
    _check_inputs(L, skip, w, b, enc=enc, g_feat=g_feat, g_dens=g_dens, feat=feat, acts=acts)
    N = enc.shape[0]
    if (g_feat.shape != (N, H) or g_dens.shape != (N,) or feat.shape != (N, H)
            or acts.shape != (L - 1, N, H)
            or {t.dtype for t in (enc, g_feat, g_dens, feat, acts, w)} != {torch.bfloat16}):
        raise ValueError("trunk_bwd: unexpected shapes or dtypes")
    out = _bwd_outputs(N, w, b, L)
    if N == 0:
        return out[:3]
    _bwd_launch(enc, g_feat, g_dens, feat, acts, w, out, L, skip)
    bwd_launches += 1
    return out[:3]


def _bwd_outputs(N: int, w, b, L: int):
    """The backward's buffers: (denc, dw, db) and the scratch `gsave`, each
    layer's g [L, N, H] bf16 that the chain kernel writes for the dW kernel."""
    dev = w.device
    return (torch.empty((N, IN_PAD), dtype=torch.bfloat16, device=dev),
            torch.zeros(w.numel(), dtype=torch.float32, device=dev),
            torch.zeros(b.numel(), dtype=torch.float32, device=dev),
            torch.empty((L, N, H), dtype=torch.bfloat16, device=dev))


def _bwd_launch(enc, g_feat, g_dens, feat, acts, w, out, L: int, skip: int,
               kernels=("chain", "dw")) -> None:
    """Launches the backward's kernels named in `kernels` on the buffers `out`
    of `_bwd_outputs`, inputs already checked by `trunk_bwd`; dw and db are
    added to, so they start at zero. Counts nothing: `trunk_bwd` does."""
    denc, dw, db, gsave = out
    N, lib = enc.shape[0], _lib()
    stream = torch.cuda.current_stream(enc.device).cuda_stream
    if "chain" in kernels:
        _check(lib, lib.trunk_bwd_chain(_ptr(g_feat), _ptr(g_dens), _ptr(feat), _ptr(acts), _ptr(w),
                                        _ptr(denc), _ptr(gsave), _ptr(db), N, L, skip, stream),
               "trunk_bwd_chain")
    if "dw" in kernels:
        _check(lib, lib.trunk_bwd_dw(_ptr(enc), _ptr(acts), _ptr(gsave), _ptr(g_dens), _ptr(dw), N, L,
                                     skip, stream), "trunk_bwd_dw")


# ---------------------------------------------------------------------------
# autograd and the public entry


class _FusedTrunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, enc, w, b, L, skip):
        store = any(ctx.needs_input_grad[:3])
        feat, dens, acts = trunk_fwd(enc, w, b, L, skip, store_acts=store)
        ctx.save_for_backward(enc, w, b, feat, acts)
        ctx.L, ctx.skip = L, skip
        return feat, dens

    @staticmethod
    def backward(ctx, g_feat, g_dens):
        enc, w, b, feat, acts = ctx.saved_tensors
        if g_feat is None:
            g_feat = torch.zeros_like(feat)
        if g_dens is None:
            g_dens = torch.zeros(feat.shape[0], dtype=torch.float32, device=feat.device)
        denc, dw, db = trunk_bwd(enc, g_feat.to(torch.bfloat16).contiguous(),
                                 g_dens.to(torch.bfloat16).contiguous(), feat, acts, w, b,
                                 ctx.L, ctx.skip)
        return denc, dw.to(torch.bfloat16), db.to(torch.bfloat16), None, None


def fused_trunk(enc: torch.Tensor, feat_layers: list, skip: int):
    """Run the trunk on [..., D] encoded points (D <= 64).

    feat_layers: JAX-layout layers [{'w': [in, out], 'b': [out]}], layer
    `skip` taking concat([feat, enc]) and the last emitting [density | feat].
    Returns (raw_density [...] f32, feat [..., H] bf16).
    """
    lead, D = enc.shape[:-1], enc.shape[-1]
    L = len(feat_layers)
    x = F.pad(enc.reshape(-1, D).to(torch.bfloat16), (0, IN_PAD - D)).contiguous()
    w, b = pack_params(feat_layers, skip)
    feat, dens = _FusedTrunk.apply(x, w, b, L, skip)
    return dens.reshape(lead), feat.reshape(lead + (feat.shape[-1],))
