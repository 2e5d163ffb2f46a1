"""Fused scene-NeRF trunk (L x H MLP with one skip): Hopper kernels and twin.

Replaces the Pallas TPU kernels of `poseprobe_tpu/ops/pallas/fused_mlp.py`:
`_trunk_fwd_call` (forward) and `_trunk_bwd_call` (backward), entered through
`fused_trunk` with the custom VJP `_trunk_padded`. They take what the TPU
kernels take (`supports`): any uniform width H that is a multiple of 128, one
skip strictly inside, an encoded input of at most 128. The encoded input is
padded per call to 64 columns when it has at most 64, else to 128 (the
reference pads to 128 always; the pad is zeros either way). Three CUDA C++
sources (sm_90a, built with nvcc at first use and bound with ctypes):
* `csrc/fused_trunk.cu`, H = 128 and 256 with either pad: the designs below,
  templates on H and the pad (H = 256 with pad 64 is the 8x256 main path),
  but for the backward chain at H = 128;
* `csrc/trunk_narrow.cu`, the backward chain at H = 128 (its design below;
  the launch plan is `narrow_plan`);
* `csrc/trunk_wide.cu`, every H from 384 up: one `wgmma` GEMM launch per
  layer with the layer's epilogue fused in, both operands in shared memory fed
  by TMA, persistent clusters of two blocks sharing each weight stage by TMA
  multicast; activations and g go through device memory, so no width limit
  (its design below; the launch plan is `wide_plan`).
All include `csrc/hopper.cuh`, the PTX wrappers and packed layout they share.

Function (identical to the TPU kernels' numerics):
* forward: bf16 operands, f32 accumulation, bias added in f32, ReLU output
  rounded to bf16 between layers; the skip layer reads concat([act, enc]);
  the last layer's columns are reordered to [feat | density]. Outputs feat
  [N, H] bf16, raw density [N] f32 and the hidden activations that the
  checkpoint stride stores for the backward, [n_stored, N, H] bf16.
* checkpoint stride `ckpt` (the reference's `_stored_layers`;
  `fused_trunk(..., ckpt=None)` takes TRUNK_CKPT, $POSEPROBE_TRUNK_CKPT read
  at import, default 1): 1 stores all L-1 hidden layers, 0 none, k >= 2 the
  layers k-1, 2k-1, ... up to L-2 (`stored_layers`). At a stride other than
  1 the backward first recomputes the rest (`trunk_remat`): each layer not
  stored from the one before it (or the encoding), as the forward computes
  it, so the backward's inputs, and so its results, are those of stride 1 bit
  for bit. The trade is memory for work: at 8x256 and 393,216 points the
  stored layers are 1.41 GB, live from a call's forward to its backward,
  and recomputing all of them adds 0.34 ms of products to the backward's
  0.78 ms operations bound (`chip_smoke.py`'s `drive_trunk_ckpt` measures
  both sides).
* backward: the last layer's ReLU' mask comes from the forward's bf16 feat;
  the others from the hidden activations. Each layer's pre-activation
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
activation bytes plus the per-layer g) nearly balanced. At 8x128 with a
99-wide input (pad 128) the forward moves 2,308 B a point for 0.14 M
multiply-adds: bytes again (0.271 ms); at 8x512 the 1.90 M multiply-adds a
point make both directions bound by operations (1.51 ms forward, 3.02
backward). The wide family's per-layer launches move every activation and g
through device memory: ~6.1 GB a forward and ~16 GB a backward at 8x512 and
393,216 points, floors of 1.8 and 4.9 ms beside those bounds.

The remat (H = 128 and 256: `trunk_remat_kernel` of `csrc/fused_trunk.cu`)
is the forward kernel's design run over layers 0..L-2 into a transient
[L-1, N, H] buffer that `_bwd_outputs` adds to the backward's scratch: a
stored layer's tile is loaded by TMA into the warpgroup's staging tile, read
from there as the next layer's A fragment (the inverse of the epilogue's
write) and stored again by the same TMA stores; the producer streams no
weights for it, nor for the last layer; the other layers are computed as in
the forward. The chain and dW kernels then read the buffer as they read the
stored layers at stride 1: they and their instantiations are unchanged. The
forward at a stride k >= 2 (`trunk_fwd_ckpt_kernel`) shares the remat's body,
the forward's design storing layer l into slot l / k; stride 1 and a stride
that stores nothing run the forward kernel as before, its text and machine
code unchanged. From H = 384 the remat is the wide
forward's per-layer GEMM launches into the buffer, with the stored layers
copied in (`trunk_wide_remat`), and the wide forward writes the layers it
does not store into its two scratch slots.

Not ported: the reference's other trunk switches, `BWD_WT`
($POSEPROBE_TRUNK_WT: pre-transposed weights for the backward's products),
`INTERLEAVE` ($POSEPROBE_TRUNK_INTERLEAVE: a tile as several sub-chains
interleaved layer by layer) and `tile` (the grid step), steer how Mosaic
lowers the TPU kernels, not what they compute; the Hopper kernels have
their own operand layouts, warpgroups and tiles (below), as `ops/grid.py`
says of the reference's XLA-lowering switches.

Wide trunks (H >= 384; `csrc/trunk_wide.cu`): a 128-point activation is 128 KB
at H = 512 and 256 KB at 1024, too much for shared memory beside a weight
ring, so each layer is its own launch. The forward and each layer of the
chain are one GEMM, points x columns, in tiles of 128 points (two consumer
warpgroups of 64) by 256 columns (a 128 tail where H is an odd multiple of
128; 64 for the last layer's density column and 64 or 128 for the encoding
inputs), `wgmma` m64nNk16 with A (the activation, or g) and B (the packed
weights, N-major for the forward through the descriptor's transpose bit,
K-major for g W^T) both in shared memory, on a 3-stage ring that a producer
warp fills by TMA; the epilogue is the layer's as above (bias + ReLU + bf16 and
the density; the ReLU' mask from the stored activation, db, g into `gsave`,
denc), its bf16 tile sent out by TMA stores from a staging tile (into which
the chain's producer first brings the mask tile). Persistent clusters of two
blocks take neighbouring 128-point tiles of one column tile, each block
loading half of every weight stage and multicasting it to both. The chain starts with a seed kernel that writes the
last layer's g with its density column and that layer's db. dW is
fused_trunk.cu's design over 256-column tiles: one launch of (layer, 128 input
features, column tile, point slice) blocks, both operands MN-major in shared
memory, two neighbouring feature tiles per cluster sharing each chunk of g by
multicast; each slice of the points writes its own copy of dW (no atomics)
and a last small kernel adds the copies into dw.

The forward and dW designs below are written for H = 256; at H = 128 every
product is m64n128 (half the accumulators and A fragments), and with the
128-wide pad layer 0 and the skip layer take two 64-column encoding boxes
(the H = 256 chain's encoding pass is m64n128, and with pad 128 it runs a
3-stage weight ring to fit the doubled encoding gradient). The chain at
H = 128 has a design of its own, after the backward's.

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
* The chain kernel (H = 256) walks the layers backwards for 128 points per
  block: two consumer warpgroups of 64 points run `wgmma` m64nNk16 with g in
  registers (the masked f32 accumulator of one layer, packed to bf16, is the
  next layer's A fragment) and weight tiles from a 4-stage ring that a producer
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

The chain at H = 128 (`csrc/trunk_narrow.cu`): a layer is a quarter of the
products of H = 256's for half the bytes, so there the chain is bound by
device memory (the mask read and g written, ~1.8 GB at 8x128 and 393,216
points, 0.54 ms) and, in the design above, by what each tile and layer costs
besides. Persistent blocks, one per multiprocessor (`narrow_plan`), walk
256-point tiles; four consumer warpgroups each run one 64-point sub-tile
through every layer, four independent chains per multiprocessor. A producer
warp streams [128 inputs x 64 outputs] weight stages by TMA into a 2-stage
ring that serves all four, running on across layers and tiles. Each
warpgroup moves its masks and g as 64 x 64 TMA boxes with the 128-byte
swizzle through three slots: the epilogue writes g over the mask it read,
the slot goes out to `gsave` by TMA and is the next layer's A operand, read
by `wgmma` from shared memory (no operand in registers), and once read it
takes the mask two layers ahead. Each consumer warp adds its column sums of
g to its own copy of db in device memory; the block adds its copies at its
end and a small kernel adds the blocks' in block order, so db is the same
from run to run. The skip layer's encoding part goes through denc itself.
"""
from __future__ import annotations

import functools
import os

import torch
import torch.nn.functional as F

from . import _build
from ._build import check as _check, ptr as _ptr

MAX_IN = 128     # widest encoded input the kernels take, as the reference's IN_PAD
DENS_PAD = 128   # last layer: [feat(H) | density | zeros] = H + DENS_PAD columns
WGMMA_WIDTHS = (128, 256)   # widths of csrc/fused_trunk.cu; wider ones go to csrc/trunk_wide.cu
# the activation checkpoint stride of `fused_trunk` when the call names none, read at import as the
# reference reads it: 0 stores no hidden layer, 1 all of them, k >= 2 every k-th (`stored_layers`)
TRUNK_CKPT = int(os.environ.get("POSEPROBE_TRUNK_CKPT", "1"))

# launch counts of the kernels: every call (`fwd_launches`, `bwd_launches`) and,
# in `launches` below, by the kernel instantiation it launched; the CPU twin
# does not count
fwd_launches = 0
bwd_launches = 0


# ---------------------------------------------------------------------------
# layout


def supports(cfg) -> bool:
    """True when the scene config's trunk fits the kernels, as the reference's
    `supports`: L >= 2 layers all of one width H, a multiple of 128, one skip
    strictly inside, encoded input at most 128 wide."""
    feat = tuple(cfg.layers_feat)
    return (len(feat) >= 2 and feat[0] > 0 and feat[0] % 128 == 0 and all(d == feat[0] for d in feat)
            and len(cfg.skip) == 1 and 0 < cfg.skip[0] < len(feat)
            and cfg.input_3d_dim <= MAX_IN)


def in_pad(D: int) -> int:
    """The encoded input's padded width: 64 for D <= 64, else 128."""
    if not 0 < D <= MAX_IN:
        raise ValueError(f"trunk kernels take an encoded input of 1..{MAX_IN} columns, got {D}")
    return 64 if D <= 64 else MAX_IN


def kernel_name(kind: str, width: int, pad: int) -> str:
    """The name of the kernel instantiation that runs a trunk of this width and
    input pad, for `kind` "fwd", "bwd" or "remat": `trunk_fwd` / `trunk_bwd` /
    `trunk_remat` for the 8x256 main path's (256, 64), `trunk_<kind>_h<H>_in<pad>`
    for the other `csrc/fused_trunk.cu` ones, `trunk_<kind>_wide` for
    `csrc/trunk_wide.cu`."""
    if width not in WGMMA_WIDTHS:
        return f"trunk_{kind}_wide"
    return f"trunk_{kind}" if (width, pad) == (256, 64) else f"trunk_{kind}_h{width}_in{pad}"


KERNEL_NAMES = tuple(kernel_name(kind, width, pad) for kind in ("fwd", "bwd", "remat")
                     for width, pad in ((256, 64), (256, 128), (128, 64), (128, 128), (384, 64)))
launches = dict.fromkeys(KERNEL_NAMES, 0)   # launches by kernel instantiation


def stored_layers(L: int, ckpt: int) -> tuple:
    """The hidden layers (0..L-2) that a forward of checkpoint stride `ckpt`
    stores, as the reference's `_stored_layers`: none for ckpt <= 0, all for
    1, k-1, 2k-1, ... for k >= 2."""
    if ckpt <= 0:
        return ()
    return tuple(range(ckpt - 1, L - 1, ckpt))


def _stored(L: int, store_acts) -> tuple:
    """The stored set that `store_acts` names: True all hidden layers, False
    none, else the layers themselves."""
    if store_acts is True or store_acts is False:
        return stored_layers(L, int(store_acts))
    return tuple(store_acts)


def _stride(L: int, stored: tuple) -> int:
    """The checkpoint stride whose stored layers are `stored` (0 for none):
    the kernels store only such sets."""
    k = stored[0] + 1 if stored else 0
    if stored_layers(L, k) != stored:
        raise ValueError(f"the trunk kernels store the layers of a checkpoint stride, not {stored} of L={L}")
    return k


def layout(L: int, skip: int, width: int, pad: int) -> list:
    """Per layer (K, NO, w_offset, b_offset) of the packed weight/bias buffers:
    layer l is a row-major [K, NO] block; K = pad (l = 0), width + pad (the
    skip layer), width otherwise; NO = width, or width + DENS_PAD for the
    last layer."""
    out, wo, bo = [], 0, 0
    for l in range(L):
        K = pad if l == 0 else (width + pad if l == skip else width)
        NO = width + DENS_PAD if l == L - 1 else width
        out.append((K, NO, wo, bo))
        wo += K * NO
        bo += NO
    return out


def pack_params(feat_layers: list, skip: int):
    """JAX-layout trunk layers ({'w': [in, out], 'b': [out]}) -> packed bf16
    (w_flat, b_flat) in the kernel layout, the input padded to
    `in_pad(D)`. Differentiable: the gradient of the packed buffers flows back
    to each layer's w and b."""
    L = len(feat_layers)
    width = feat_layers[0]["w"].shape[1]
    pad = in_pad(feat_layers[0]["w"].shape[0])
    ws, bs = [], []
    for l, layer in enumerate(feat_layers):
        w = layer["w"].to(torch.bfloat16)
        b = layer["b"].to(torch.bfloat16)
        if l == 0:
            w = F.pad(w, (0, 0, 0, pad - w.shape[0]))
        elif l == skip:
            w = F.pad(w, (0, 0, 0, width + pad - w.shape[0]))
        if l == L - 1:
            # [density | feat] -> [feat | density | zeros]
            w = F.pad(torch.cat([w[:, 1:], w[:, :1]], dim=1), (0, DENS_PAD - 1))
            b = F.pad(torch.cat([b[1:], b[:1]]), (0, DENS_PAD - 1))
        ws.append(w.reshape(-1))
        bs.append(b)
    return torch.cat(ws), torch.cat(bs)


WIDE_TILE = 256      # output columns of a wide GEMM tile (a 128 tail; 64 / 128 extra tiles)
WIDE_CLUSTER = 2     # blocks of a cluster: neighbouring point tiles share each weight stage
DW_POINTS = 64       # points of a dW chunk
DW_FEATURES = 128    # input features of a dW tile: two warpgroups of 64
DW_CLUSTER = 2       # dW tiles of a cluster: neighbouring feature tiles share each chunk of g


def wide_col_tiles(cm: int, xw: int) -> list:
    """The column tiles (first column, width) of a wide GEMM: [0, cm) in
    WIDE_TILE-wide tiles with a 128-wide tail, then one tile of xw columns at
    cm (none when xw is 0), as `col_tile` in csrc/trunk_wide.cu."""
    tiles = [(c0, min(WIDE_TILE, cm - c0)) for c0 in range(0, cm, WIDE_TILE)]
    return tiles + ([(cm, xw)] if xw else [])


def wide_plan(n: int, L: int, skip: int, width: int, pad: int, sms: int) -> dict:
    """The numbers the wide kernels' wrapper computes and passes for n points
    on a card with `sms` multiprocessors: `clusters`, the most clusters of two
    blocks a persistent GEMM launch takes (one block per multiprocessor);
    `dw_pairs`, the dW grid's clusters along x (every layer's 128-feature
    tiles taken two at a time, times its column tiles: 256 wide, a 128 tail,
    and for the last layer the 128 columns from H); `dw_splits` slices of
    `dw_rows_per_split` points along y, each a whole number of 64-point chunks
    and none empty: the fewest slices (up to 32) whose clusters fill at least
    97% of the waves they take, else the fullest (at 8x512, 393,216 points on
    an H100: 17 slices, against 7 at 90%, took dW from 3.07 to 2.73 ms);
    `slots`, the activation buffers of a forward without stored activations
    (the backward's scratch is `_bwd_outputs`'s, and dW's [dw_splits,
    w.numel()] f32 slices)."""
    def cdiv(a, b):
        return -(-a // b)

    clusters = max(1, sms // WIDE_CLUSTER)
    pairs = sum(cdiv(cdiv(K, DW_FEATURES), DW_CLUSTER) * len(wide_col_tiles(width, DENS_PAD if l == L - 1 else 0))
                for l, (K, *_) in enumerate(layout(L, skip, width, pad)))
    chunks = max(1, cdiv(n, DW_POINTS))
    best, best_fill = 1, 0.0
    for s in range(1, min(32, chunks) + 1):
        fill = s * pairs / (cdiv(s * pairs, clusters) * clusters)
        if fill >= 0.97:
            best = s
            break
        if fill > best_fill + 1e-9:
            best, best_fill = s, fill
    per = cdiv(chunks, best)
    return {"clusters": clusters, "dw_pairs": pairs, "dw_splits": cdiv(chunks, per),
            "dw_rows_per_split": per * DW_POINTS, "slots": min(2, L - 1)}


NARROW_WIDTH = 128    # the width whose backward chain runs csrc/trunk_narrow.cu
NARROW_TILE = 256     # points of a narrow block's tile: four consumer warpgroups of 64
NARROW_WARPS = 16     # consumer warps of a narrow block, each with its own copy of db
NARROW_RING = 2       # weight stages of [128 inputs x 64 outputs], 16 KB each
NARROW_SLOTS = 3      # mask / g slots of [64 points x 128] bf16, 16 KB each, per warpgroup


def narrow_plan(n: int, L: int, pad: int, sms: int) -> dict:
    """What the wrapper passes csrc/trunk_narrow.cu's chain for n > 0 points
    on a card with `sms` multiprocessors (the C side refuses another plan):
    `tiles` of NARROW_TILE points, `blocks` persistent blocks (one per
    multiprocessor, no more than the tiles; block b takes tiles b, b +
    blocks, ...: at most `tiles_per_block`), `db_part` the f32 scratch for
    the blocks' db copies (NARROW_WARPS a block, each the first L * 128 + 1
    columns of db), and `smem` the block's shared-memory bytes (1 KB of
    alignment, the weight ring, the warpgroups' slots, the last layer's
    density column as f32, the mbarriers)."""
    tiles = -(-n // NARROW_TILE)
    blocks = max(1, min(sms, tiles))
    box = 64 * 64 * 2
    smem = (1024 + NARROW_RING * 2 * box + 4 * NARROW_SLOTS * 2 * box + (NARROW_WIDTH + pad) * 4
            + (2 * NARROW_RING + 4 * NARROW_SLOTS) * 8)
    return {"tiles": tiles, "blocks": blocks, "tiles_per_block": -(-tiles // blocks),
            "db_part": blocks * NARROW_WARPS * (L * NARROW_WIDTH + 1), "smem": smem}


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _width(b: torch.Tensor, L: int) -> int:
    return (b.numel() - DENS_PAD) // L


# ---------------------------------------------------------------------------
# plain PyTorch twin (same roundings, f32 products of bf16 values)


def _pre(x, a, w, b, lay, l: int, skip: int):
    """Layer l's f32 pre-activation from the encoding x and the previous
    layer's activation a (both f32 of bf16 values)."""
    K, NO, wo, bo = lay[l]
    inp = x if l == 0 else (torch.cat([a, x], dim=1) if l == skip else a)
    return inp @ w[wo:wo + K * NO].view(K, NO).float() + b[bo:bo + NO].float()


def trunk_fwd_plain(enc, w, b, L: int, skip: int, store_acts=True):
    """(feat, dens, the stored layers [n_stored, N, H] or None): `store_acts`
    True stores every hidden layer, False none, a tuple those layers."""
    stored = _stored(L, store_acts)
    width = _width(b, L)
    lay = layout(L, skip, width, enc.shape[1])
    x = enc.float()
    a = x
    acts = []
    for l in range(L):
        pre = _pre(x, a, w, b, lay, l, skip)
        if l < L - 1:
            a = torch.relu(pre).to(torch.bfloat16)
            if l in stored:
                acts.append(a)
            a = a.float()
        else:
            feat = torch.relu(pre[:, :width]).to(torch.bfloat16)
            dens = pre[:, width].contiguous()
    return feat, dens, (torch.stack(acts) if acts else None)


def trunk_remat_plain(enc, acts, w, b, L: int, skip: int, ckpt: int):
    """Every hidden layer [L-1, N, H] bf16 from the encoding and the layers a
    forward of stride `ckpt` stored (`acts`, [n_stored, N, H], or None): a
    stored layer as it is, the others recomputed from the one before, as the
    forward computes them (the reference backward's remat)."""
    stored = stored_layers(L, ckpt)
    lay = layout(L, skip, _width(b, L), enc.shape[1])
    x = enc.float()
    a, out = x, []
    for l in range(L - 1):
        h = acts[stored.index(l)] if l in stored else torch.relu(_pre(x, a, w, b, lay, l, skip)).to(torch.bfloat16)
        out.append(h)
        a = h.float()
    return torch.stack(out)


def trunk_bwd_plain(enc, g_feat, g_dens, feat, acts, w, b, L: int, skip: int, ckpt: int = 1):
    """Backward of `trunk_fwd_plain` from the layers stride `ckpt` stored
    (`acts`), the others recomputed first (`trunk_remat_plain`)."""
    if ckpt != 1:
        acts = trunk_remat_plain(enc, acts, w, b, L, skip, ckpt)
    width = _width(b, L)
    N = enc.shape[0]
    x = enc.float()
    g = torch.cat([torch.where(feat > 0, g_feat.float(), 0.0), g_dens.float()[:, None],
                   x.new_zeros(N, DENS_PAD - 1)], dim=1)
    lay = layout(L, skip, width, enc.shape[1])
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
    """The three libraries: csrc/fused_trunk.cu's (widths 128 and 256),
    csrc/trunk_wide.cu's (wider) and csrc/trunk_narrow.cu's (the chain at
    width 128)."""
    return (_build.declare(_build.load("fused_trunk"), trunk_fwd="ppppppiiiiiip", trunk_remat="pppppiiiiiip",
                           trunk_bwd_chain="ppppppppiiiiip", trunk_bwd_dw="pppppiiiiip"),
            _build.declare(_build.load("trunk_wide"), trunk_wide_fwd="pppppppiiiiiiip",
                           trunk_wide_remat="pppppiiiiiiip", trunk_wide_bwd_chain="ppppppppiiiiiip",
                           trunk_wide_bwd_dw="pppppiiiiiiiip"),
            _build.declare(_build.load("trunk_narrow"), trunk_narrow_bwd_chain="pppppppppiiiiilip"))


def _check_inputs(L: int, skip: int, enc, w, b, **tensors) -> tuple:
    """(H, pad) of the packed trunk after checking what the kernels take:
    H a positive multiple of 128 (from b), pad 64 or 128 (enc's columns), w
    and b of the layout's sizes, every tensor contiguous, 16-byte aligned and
    on w's device."""
    dev = w.device
    if not (2 <= L and 0 < skip < L):
        raise ValueError(f"trunk kernel needs L >= 2 and 0 < skip < L, got L={L} skip={skip}")
    width, pad = _width(b, L), enc.shape[-1]
    if not (width > 0 and width % 128 == 0 and b.numel() == L * width + DENS_PAD):
        raise ValueError(f"trunk kernels take a width that is a multiple of 128, got {width}")
    if pad not in (64, MAX_IN):
        raise ValueError(f"trunk kernels take an encoding padded to 64 or {MAX_IN} columns, got {pad}")
    lay = layout(L, skip, width, pad)
    if w.numel() != lay[-1][2] + lay[-1][0] * lay[-1][1]:
        raise ValueError("packed trunk weights do not match the layout")
    for name, t in dict(tensors, enc=enc, w=w, b=b).items():
        if t is None:           # stored activations of a stride that stores none
            continue
        # the kernels' tensor maps and 16-byte accesses need 16-byte aligned bases
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: expected a contiguous, 16-byte aligned tensor on {dev}")
    return width, pad


def _count(kind: str, width: int, pad: int) -> None:
    launches[kernel_name(kind, width, pad)] += 1


def _check_stored(L: int, ckpt: int, N: int, H: int, acts) -> None:
    stored = stored_layers(L, ckpt)
    if (acts is None) != (not stored) or (acts is not None and (acts.dim() != 3 or acts.shape != (len(stored), N, H)
                                                                 or acts.dtype != torch.bfloat16)):
        raise ValueError(f"expected the {len(stored)} layers that stride {ckpt} stores as [{len(stored)}, {N}, {H}] "
                         f"bfloat16 (None for none), got {None if acts is None else (acts.shape, acts.dtype)}")


def trunk_fwd(enc, w, b, L: int, skip: int, store_acts=True):
    """enc [N, pad] bf16 (pad 64 or 128), packed w/b bf16 -> (feat [N, H]
    bf16, dens [N] f32, the stored hidden layers [n_stored, N, H] bf16 or
    None). `store_acts`: True stores all L-1, False none, or the tuple
    `stored_layers(L, k)` of a checkpoint stride k. Kernel on CUDA tensors,
    twin on CPU ones."""
    global fwd_launches
    if not enc.is_cuda:
        return trunk_fwd_plain(enc, w, b, L, skip, store_acts)
    H, pad = _check_inputs(L, skip, enc, w, b)
    stored = _stored(L, store_acts)
    ckpt = _stride(L, stored)
    N = enc.shape[0]
    if enc.dim() != 2 or {enc.dtype, w.dtype, b.dtype} != {torch.bfloat16}:
        raise ValueError("trunk_fwd expects enc [N, 64 or 128], w and b in bfloat16")
    feat = torch.empty((N, H), dtype=torch.bfloat16, device=enc.device)
    dens = torch.empty(N, dtype=torch.float32, device=enc.device)
    acts = (torch.empty((len(stored), N, H), dtype=torch.bfloat16, device=enc.device)
            if stored else None)
    if N == 0:
        return feat, dens, acts
    lib = _lib()[H not in WGMMA_WIDTHS]
    stream = torch.cuda.current_stream(enc.device).cuda_stream
    if H in WGMMA_WIDTHS:
        _check(lib, lib.trunk_fwd(_ptr(enc), _ptr(w), _ptr(b), _ptr(feat), _ptr(dens), _ptr(acts),
                                  N, L, skip, H, pad, ckpt, stream), "trunk_fwd")
    else:
        # the layers' activations go through device memory: the stored ones into acts, the
        # others into two slots of scratch
        plan = wide_plan(N, L, skip, H, pad, _sms(enc.device))
        scratch = (None if ckpt == 1 else torch.empty((plan["slots"], N, H), dtype=torch.bfloat16,
                                                      device=enc.device))
        _check(lib, lib.trunk_wide_fwd(_ptr(enc), _ptr(w), _ptr(b), _ptr(feat), _ptr(dens), _ptr(acts),
                                       _ptr(scratch), N, L, skip, H, pad, ckpt, plan["clusters"], stream),
               "trunk_wide_fwd")
    fwd_launches += 1
    _count("fwd", H, pad)
    return feat, dens, acts


def trunk_remat(enc, acts, w, b, L: int, skip: int, ckpt: int, out=None):
    """Every hidden layer [L-1, N, H] bf16 (into `out` when given) from enc
    and the layers `acts` [n_stored, N, H] (or None) that a forward of stride
    `ckpt` stored: those copied, the others recomputed from the nearest one
    before (or the encoding), bit for bit the forward's. Kernel on CUDA
    tensors (csrc/fused_trunk.cu's remat kernel; csrc/trunk_wide.cu's forward
    GEMM layer by layer for H >= 384), twin on CPU ones."""
    if not enc.is_cuda:
        return trunk_remat_plain(enc, acts, w, b, L, skip, ckpt)
    H, pad = _check_inputs(L, skip, enc, w, b, acts=acts, out=out)
    N = enc.shape[0]
    if enc.dim() != 2 or {enc.dtype, w.dtype, b.dtype} != {torch.bfloat16}:
        raise ValueError("trunk_remat expects enc [N, 64 or 128], w and b in bfloat16")
    _check_stored(L, ckpt, N, H, acts)
    if out is None:
        out = torch.empty((L - 1, N, H), dtype=torch.bfloat16, device=enc.device)
    elif out.shape != (L - 1, N, H) or out.dtype != torch.bfloat16:
        raise ValueError(f"trunk_remat: out must be [{L - 1}, {N}, {H}] bfloat16")
    if N == 0:
        return out
    k = ckpt if acts is not None else 0
    lib = _lib()[H not in WGMMA_WIDTHS]
    stream = torch.cuda.current_stream(enc.device).cuda_stream
    if H in WGMMA_WIDTHS:
        _check(lib, lib.trunk_remat(_ptr(enc), _ptr(w), _ptr(b), _ptr(acts), _ptr(out), N, L, skip, H, pad, k,
                                    stream), "trunk_remat")
    else:
        plan = wide_plan(N, L, skip, H, pad, _sms(enc.device))
        _check(lib, lib.trunk_wide_remat(_ptr(enc), _ptr(w), _ptr(b), _ptr(acts), _ptr(out), N, L, skip, H, pad, k,
                                         plan["clusters"], stream), "trunk_wide_remat")
    _count("remat", H, pad)
    return out


def trunk_bwd(enc, g_feat, g_dens, feat, acts, w, b, L: int, skip: int, ckpt: int = 1):
    """Backward of `trunk_fwd`: g_feat [N, H] bf16, g_dens [N] bf16, acts the
    layers that checkpoint stride `ckpt` stored ([n_stored, N, H] or None) ->
    (denc [N, pad] bf16, dw f32 packed, db f32 packed). At a stride other
    than 1 the remat kernel first refills every hidden layer into a transient
    buffer, which the chain and dW kernels read as they read the stored
    layers at stride 1. Kernels on CUDA tensors, twin on CPU ones."""
    global bwd_launches
    if not enc.is_cuda:
        return trunk_bwd_plain(enc, g_feat, g_dens, feat, acts, w, b, L, skip, ckpt)
    H, pad = _check_inputs(L, skip, enc, w, b, g_feat=g_feat, g_dens=g_dens, feat=feat, acts=acts)
    N = enc.shape[0]
    if (enc.dim() != 2 or g_feat.shape != (N, H) or g_dens.shape != (N,) or feat.shape != (N, H)
            or {t.dtype for t in (enc, g_feat, g_dens, feat, w)} != {torch.bfloat16}):
        raise ValueError("trunk_bwd: unexpected shapes or dtypes")
    _check_stored(L, ckpt, N, H, acts)
    out = _bwd_outputs(N, w, b, L, pad, ckpt)
    if N == 0:
        return out[:3]
    if ckpt != 1:
        acts = trunk_remat(enc, acts, w, b, L, skip, ckpt, out=_remat_buffer(out[3], L, N, H))
    _bwd_launch(enc, g_feat, g_dens, feat, acts, w, out, L, skip)
    bwd_launches += 1
    _count("bwd", H, pad)
    return out[:3]


def _bwd_outputs(N: int, w, b, L: int, pad: int, ckpt: int = 1):
    """The backward's buffers: (denc, dw, db) and the scratch `gsave`, each
    layer's g that the chain kernel writes for the dW kernel: [L, N, H] bf16;
    for the wide kernels layers 0..L-2 as [L-1, N, H] then the last layer's g
    with its density column, [N, H + DENS_PAD] (flat). At a checkpoint stride
    other than 1 the scratch also holds, at its end, the transient [L-1, N, H]
    that the remat fills (`_remat_buffer`): freed with the rest when the
    backward returns."""
    dev, H = w.device, _width(b, L)
    scratch = L * N * H + (0 if H in WGMMA_WIDTHS else N * DENS_PAD) + (0 if ckpt == 1 else (L - 1) * N * H)
    return (torch.empty((N, pad), dtype=torch.bfloat16, device=dev),
            torch.zeros(w.numel(), dtype=torch.float32, device=dev),
            torch.zeros(b.numel(), dtype=torch.float32, device=dev),
            torch.empty(scratch, dtype=torch.bfloat16, device=dev))


def _remat_buffer(gsave, L: int, N: int, H: int):
    """The [L-1, N, H] at the end of `_bwd_outputs`'s scratch."""
    return gsave[gsave.numel() - (L - 1) * N * H:].view(L - 1, N, H)


def _bwd_launch(enc, g_feat, g_dens, feat, acts, w, out, L: int, skip: int,
                kernels=("chain", "dw")) -> None:
    """Launches the backward's kernels named in `kernels` on the buffers `out`
    of `_bwd_outputs`, inputs already checked by `trunk_bwd`; dw and db are
    added to, so they start at zero. Counts nothing: `trunk_bwd` does."""
    denc, dw, db, gsave = out
    (N, pad), H = enc.shape, feat.shape[1]
    wide = H not in WGMMA_WIDTHS
    lib = _lib()[wide]
    stream = torch.cuda.current_stream(enc.device).cuda_stream
    ptrs = (_ptr(g_feat), _ptr(g_dens), _ptr(feat), _ptr(acts), _ptr(w), _ptr(denc), _ptr(gsave), _ptr(db))
    if not wide:
        if "chain" in kernels and H == NARROW_WIDTH:
            # each consumer warp of each block sums db into its copy, and the copies are added into db
            plan = narrow_plan(N, L, pad, _sms(enc.device))
            part = torch.empty(plan["db_part"], dtype=torch.float32, device=w.device)
            narrow = _lib()[2]
            _check(narrow, narrow.trunk_narrow_bwd_chain(*ptrs, _ptr(part), N, L, skip, pad, plan["blocks"],
                                                         plan["db_part"], plan["smem"], stream),
                   "trunk_narrow_bwd_chain")
        elif "chain" in kernels:
            _check(lib, lib.trunk_bwd_chain(*ptrs, N, L, skip, H, pad, stream), "trunk_bwd_chain")
        if "dw" in kernels:
            _check(lib, lib.trunk_bwd_dw(_ptr(enc), _ptr(acts), _ptr(gsave), _ptr(g_dens), _ptr(dw), N, L, skip,
                                         H, pad, stream), "trunk_bwd_dw")
        return
    plan = wide_plan(N, L, skip, H, pad, _sms(enc.device))
    if "chain" in kernels:
        _check(lib, lib.trunk_wide_bwd_chain(*ptrs, N, L, skip, H, pad, plan["clusters"], stream),
               "trunk_wide_bwd_chain")
    if "dw" in kernels:
        # each slice of the points writes its copy of dW, and the copies are added into dw
        part = torch.empty((plan["dw_splits"], w.numel()), dtype=torch.float32, device=w.device)
        _check(lib, lib.trunk_wide_bwd_dw(_ptr(enc), _ptr(acts), _ptr(gsave), _ptr(part), _ptr(dw), N, L, skip, H,
                                          pad, plan["dw_pairs"], plan["dw_splits"], plan["dw_rows_per_split"], stream),
               "trunk_wide_bwd_dw")


# ---------------------------------------------------------------------------
# autograd and the public entry


class _FusedTrunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, enc, w, b, L, skip, ckpt):
        # the layers of the stride, [n_stored, N, H] (None when it stores none), only for a backward
        stored = stored_layers(L, ckpt) if any(ctx.needs_input_grad[:3]) else False
        feat, dens, acts = trunk_fwd(enc, w, b, L, skip, store_acts=stored)
        ctx.save_for_backward(enc, w, b, feat, acts)
        ctx.L, ctx.skip, ctx.ckpt = L, skip, ckpt
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
                                 ctx.L, ctx.skip, ctx.ckpt)
        return denc, dw.to(torch.bfloat16), db.to(torch.bfloat16), None, None, None


def fused_trunk(enc: torch.Tensor, feat_layers: list, skip: int, ckpt: int | None = None):
    """Run the trunk on [..., D] encoded points (D <= 128), or on the encoding
    already bf16 and zero-padded to `in_pad(D)` columns, which it takes as it is.

    feat_layers: JAX-layout layers [{'w': [in, out], 'b': [out]}], layer
    `skip` taking concat([feat, enc]) and the last emitting [density | feat].
    `ckpt`: the activation checkpoint stride (default the module's
    TRUNK_CKPT, $POSEPROBE_TRUNK_CKPT, read at this call): 0 stores no hidden
    layer for the backward, 1 all of them, k >= 2 every k-th; the backward
    recomputes the rest. The results are the same bit for bit at every stride.
    Returns (raw_density [...] f32, feat [..., H] bf16).
    """
    ckpt = TRUNK_CKPT if ckpt is None else ckpt
    lead, D = enc.shape[:-1], enc.shape[-1]
    L = len(feat_layers)
    x = enc.reshape(-1, D).to(torch.bfloat16)
    if in_pad(D) != D:              # F.pad copies even a pad of nothing
        x = F.pad(x, (0, in_pad(D) - D))
    x = x.contiguous()
    w, b = pack_params(feat_layers, skip)
    feat, dens = _FusedTrunk.apply(x, w, b, L, skip, ckpt)
    return dens.reshape(lead), feat.reshape(lead + (feat.shape[-1],))
