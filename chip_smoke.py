"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--lookup-points FILE]

Builds the port's CUDA kernels from `poseprobe_tpu_torch/csrc/` (seven
sources, one nvcc each, in parallel) and holds each kernel against its plain
PyTorch version on the card:
* the fused-trunk kernels at the mid-phase fine render's 393,216 points and
  at a ragged point count;
* the scene encoding's kernels (`posenc.cu`) at the same points, at a render
  chunk's 1,048,576 and at a ragged count: the forward bit for bit against
  the plain chain, the backward against autograd through it, each timed
  beside the plain chain with its bound (bytes);
* the layout kernels (`transpose2d`, `transpose_slice`, `materialize`) at the
  96^3 x 13-channel grid's shapes and at ragged ones, bit for bit (no path
  launches the two transposes: the lookup works on the grid's own layout);
* the trilinear kernels at 96^3 with 1 channel (value + gradient) and 13
  channels (value), at the early step's point count, at 1024 x n_samples and
  at a ragged count, with points on voxel corners, on the border and outside,
  against the twin and their plain versions; the 13-channel backward also
  with POSEPROBE_SCATTER_BARRIER=1 (the staged scatter through
  `materialize`), against the twin and the direct scatter. The whole lookup
  from the [C, X, Y, Z] grid (forward: the gather; backward: zero-fill +
  scatter, both straight on [C, X, Y, Z]) is timed in turns beside
  `F.grid_sample` and its backward, with L2 warm and flushed (device times
  from torch.profiler), for 13 and 1 channels at uniform points and at the
  points of each grid lookup of one early step, captured from the
  bench-scale joint trainer at its first step and again after `fit()` below
  (three views active, the mask cache refreshed);
* the fused alpha-composite kernels (forward and hand-written one-pass
  backward) at the early step's [1024 rays, chord-bound K samples], at the
  dense [1024, n_samples], at ragged shapes, for a soft and a sharp NeuS
  sigmoid, with saturated, grazing and masked rays; at [1024, K] each kernel's
  device time (torch.profiler) as a bare launch and through its wrapper, with
  the wrapper's device events per call; past the 1024-sample tile (1025,
  1312, 2048, 4096 and 8192 samples; the last two in several stages) the ray
  kernels, timed in turns at [1024, 2048] and [1024, 1312], L2 warm and
  flushed.
Beside each kernel's time stands the time of the one PyTorch call that
computes the same function, where there is one (a copy for the layout
kernels, `F.grid_sample` and its backward for the trilinear ones): timed and
checked here, used nowhere in the port. `materialize` is also timed beside the
copy designs it was chosen against, the trunk forward also without stored
activations, and the trunk backward's two kernels apart.
Then it drives the training step at bench scale (bf16 trunk): a few
coarse-phase and mid-phase steps of the scene-only trainer
(`build_scene_trainer`) and a few early-phase steps of the joint trainer
(`build_trainer`, object branch on), checking that the losses are finite,
that the kernels carried every trunk render and every grid lookup (launch
counters), that one step's loss through the kernels agrees with the same
step through the plain PyTorch versions, and that a step with
POSEPROBE_SCATTER_BARRIER=1 (the scatter updates pass through `materialize`)
gives the same loss. In each phase it also runs a superstep window of 4
steps (`steps_scan`: the first step eager under
`torch.cuda.set_sync_debug_mode("error")`, then the step captured as a CUDA
graph and replayed) from a cloned state, holds its losses and final state
against 4 eager steps from the same state, and prints its step ms beside the
eager step's; the kernels' launch counters count the replays. Last it drives
`JointTrainer.fit(superstep=4)` at the same scale
with PnP pose seeding and the fused composite on: the PnP chain at
construction, the early steps through the composite kernels, the activation
of the third view (PnP against the probe, photometric gate, guarded warmup and
fixed-ray scores rendered on the card), a mask-cache refresh and a BA-polish
event, then the probe health check and a validation render. OpenCV is
optional: without it PnP runs the numpy RANSAC and the BA polish and the match
refinement decline, as in the reference; the script says which path ran.
Then it trains a published preset from data on disk (`drive_preset`): the
synthetic scene rendered at DTU's 1600x1200 is written as a four-view DTU
scan (IDR layout, PNGs by the port's own writer), loaded by `load_dtu` under
`presets/dtu_generic` (the classical matcher when OpenCV is there, else the
fixture's analytic packs, said on the line), the trainer built (PnP chain,
feature maps), `fit(20, superstep=4)` run across the activation of view 2;
then step 3001, past the last pg_scale doubling (the grid at 96^3), runs as a
graph window held against eager steps, with the surface-feature term's valid
rays counted, and is profiled (eager and graph step time, device time, peak
memory; `profile_step.profile_phase`).
Last, the two CLIs on that scan (`drive_cli`, in a working directory of
its own): `python -m poseprobe_tpu_torch.run` trains `dtu_generic` at full
width for 40 steps (pg_scale doublings at 8, 16 and 24, view 2 activated and
the phases flipped at 12, checkpoints at 20 and 40, the test-set evaluation,
the mesh); the checkpoint is read back and written again, timed; a trainer
resumed from a checkpoint is held against the run without the break;
`python -m poseprobe_tpu_torch.evaluate` evaluates the last checkpoint (with
and without test-time optimization, the mesh from a 256^3 volume); a full
render, a test-time optimization, the volume and the marching are timed
apart with their launches; the synthetic run + evaluate pair gives its
chamfer; three frames of the spiral video are rendered; and the trunk and
trilinear kernels are held against their plain versions at the evaluation
path's shapes (a render chunk, a test-time iteration, a volume chunk, a mesh
colour chunk).
Last, the single-card paths that came last (`drive_last_paths`): the early
step of `build_trainer()`'s workload with the TensoRF k0 (96^3, 24
components, 12 channels) -- eager steps, the kernels held at its lookups and
trunk calls, one step against the plain versions, a graph window against
eager steps and its profile, `tensorf_sample`'s device time beside the dense
12-channel lookup, a doubling through `tensorf_resize` after which the next
window captures again, a checkpoint read back bit for bit; the mid step of
`build_scene_trainer()` with the corres weight removed, so that depth
consistency renders fresh reference pixels (trunk launches counted, the
kernels held at its calls, a graph window against eager steps); SuperPoint +
SuperGlue with seeded random weights on the preset's 1600x1200 scan
(`load_dtu` with the SuperGlue backend on the card, device time per image and
per pair, the card's maps and log assignment against the CPU's, a trainer
fitted on those packs); and `run --synthetic --grid_type tensorf
--match_source superglue --matcher superglue` with `evaluate --eval_mesh` on
its checkpoint.
Last, the parallel package (`drive_parallel`, `poseprobe_tpu_torch/parallel/`):
two spawned ranks (NCCL with one rank per card where there are two cards,
else gloo with both on cuda:0; a file rendezvous, a deadline that ends every
rank) run `build_trainer()` at full width on a ('data',) mesh -- the early
step from step 1 and a mid step, held against the same steps on one rank
(this process) in the loss and in the params and Adam moments, the ranks'
params bit for bit equal, and `fit(4, superstep=2)` across a view activation
(rank 0's state broadcast after it) -- then `train_step_tp` at 192^3 (1024
rays x 96 samples) and `joint_step_tp` with the bf16 trunk on a (1, 2) mesh,
held against the unsharded steps, with the trilinear kernels held at the
halo-extended slab; each rank counts its trunk and trilinear launches. Then one
NCCL rank: `fit(4, superstep=4)`, its step captured with the gradient
all-reduce inside the graph, against two runs without a mesh. It prints the DP
step ms on two ranks and one, the all-reduce's ms and bytes, the TP step's and
the halo's ms.
Last, the trunk and the composite over the rest of the reference's domain
(`drive_trunk_widths`, `drive_long_rays`): `build_trainer()`'s workload at its
mid step with an 8x128 trunk at L_3D 16 (input 99, padded to 128) and an 8x512
one (the wide kernels of `csrc/trunk_wide.cu`): eager steps with every trunk
call counted under the kernel instantiation that takes it, the kernels held
at the step's own calls, the loss against the plain trunk, a graph window
against eager steps and its profile, each instantiation timed at the fine
render's 393,216 points; then its early step with the fused composite at
stepsize 0.08 (2101 samples, K 1312 > 1024), through the ray kernels,
against the unfused step.
Last, the trunk's activation-checkpoint strides (`drive_trunk_ckpt`;
`fused_mlp.TRUNK_CKPT`, $POSEPROBE_TRUNK_CKPT): at every trunk instantiation
(8x256 with pads 64 and 128, 8x128 with both, 8x384, 8x512) and 393,216 and
100,003 points, strides 0 and 2 against stride 1: the forward's outputs and
stored layers, the remat kernel's refilled layers and the backward's denc bit
for bit (dW and db too where they are summed in a fixed order), the remat and
the backward against their plain versions; the forward, backward, remat, chain
and dW timed at strides 1, 0, 2 in turns; then `build_trainer()`'s mid step at
strides 0 and 2 (8x256) and 0 (8x128, 8x512) against stride 1 from one state:
the loss, the params after the step, launches by kernel (4 remats a step), the
peak memory, a graph window at each stride against eager steps.
With `--lookup-points FILE` it also saves the captured lookup points there
(`torch.save`), for `tools/lookup_times.py`.

Prints the card (`nvidia-smi` name and power limit), the build time, errors
and times, one JSON line `{"kernels": [...]}` and, last, one JSON line
`{"ok": true, "device": {...}}`. Any failed check raises: the script exits
non-zero and prints no result. It needs a CUDA card and the repository
around it; it has no CPU path.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor-core rate and HBM rate
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12          # float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12
FINE_POINTS = (1024 + 2 * 256) * 256   # mid-phase fine render: (rays + corres pair rays) x 256
RAGGED_POINTS = 100_003                # not a multiple of the 128-point tile
RENDER_CHUNK_POINTS = 4096 * 256       # a render chunk's fine samples: 4096 rays x (128 + 128)
REL_TOL = 2e-2                         # max abs error allowed, as a fraction of max |twin|
COMPOSITE_TILE = 1024                  # ops/fused_composite.TILE: longer rays go to the ray kernels
CHUNKED_S = (1025, 2048, 4096, 8192)   # sample counts past the tile held (4096, 8192: several stages)
LONG_RAY_K = 1312                      # the long-ray early step's chord-bound K, also held and timed
TRI_REL_TOL, TRI_ABS_TOL = 1e-5, 1e-6  # trilinear kernels: float32 sums in another order (atomics)
# superstep windows (`steps_scan`, a captured step replayed) against as many eager steps from one
# state: per-step losses within GRAPH_LOSS_RTOL, every parameter tensor within REL_TOL in the L2
# norm relative to its own, step and Adam counters equal. Both run the same kernels on the same
# draws; the trilinear scatter and the trunk's dW/db add with atomics in a run-dependent order, so
# a gradient element that is a near-cancelling sum can change sign, and Adam then steps it up to
# 2 lr the other way (0.2 for the SDF grid's first step): the difference is sparse and not bounded
# elementwise by the rounding, hence the norm.
SUPERSTEP = 4
GRAPH_LOSS_RTOL = 1e-3
# kernels that no path launches: the lookup reads the grid and writes its gradient in their own
# layout, so the layout kernels that moved them to and from rows are held and timed here, and
# expected at 0 launches on every path
OFF_PATH = ("transpose2d", "transpose_slice")
DEVICE = "cuda"
SMALL = False                          # bench scale
PRESET_HW = (1200, 1600)               # the preset phase's DTU-layout fixture: DTU's own resolution
PRESET_VIEWS = 4                       # three train views and one test view
# the copy designs `materialize_kernel` was chosen against (`materialize_design` in csrc/layout.cu)
MATERIALIZE_DESIGNS = {"unroll4_4_blocks_per_sm": 1, "unroll4_8_blocks_per_sm": 2, "bulk_ring_2_blocks_per_sm": 3}


def _time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _rotating(fn, inputs):
    """fn applied to the next of `inputs` at every call, so that a timed copy
    reads from device memory and not from what the last call left in L2."""
    state = {"i": 0}

    def call():
        state["i"] = (state["i"] + 1) % len(inputs)
        return fn(inputs[state["i"]])
    return call


def _max_err(outs, refs) -> tuple[float, float]:
    """(max abs error, max abs error / max |ref|) over paired outputs."""
    worst_abs, worst_rel = 0.0, 0.0
    for o, r in zip(outs, refs):
        err = float((o.float() - r.float()).abs().max())
        scale = max(float(r.float().abs().max()), 1e-30)
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, err / scale)
    return worst_abs, worst_rel


def _trunk_macs(cfg) -> int:
    """Multiply-adds per point of the trunk (unpadded): 491,264 at 8x256, skip 4."""
    D, H, L = cfg.input_3d_dim, cfg.layers_feat[0], len(cfg.layers_feat)
    macs = 0
    for l in range(L):
        k_in = (D if l == 0 else H) + (D if l == cfg.skip[0] else 0)
        macs += k_in * (H + 1 if l == L - 1 else H)
    return macs


def _bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _record(name: str, source: str, replaces: str, err: float, ms: float, plain_ms: float,
            flops: float, nbytes: float, library_ms, peak_flops: float = PEAK_BF16_FLOPS) -> dict:
    bound_ms, bound_by = _bound(flops, nbytes, peak_flops)
    print(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
          f"{'none' if library_ms is None else format(library_ms, '.4f') + ' ms'}, bound {bound_ms:.4f} ms "
          f"({bound_by}: {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB)")
    return {"name": name, "route": "cuda", "source": f"poseprobe_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def check_trunk_kernels(fused_mlp, scene_nerf, pe) -> list:
    """Forward and backward kernels vs the twin at the main shape and a ragged
    one; returns the kernel records (errors and times at the main shape)."""
    cfg = scene_nerf.SceneConfig()
    L, skip = len(cfg.layers_feat), cfg.skip[0]
    gen = torch.Generator().manual_seed(0)
    mlp = scene_nerf.init_nerf_mlp(gen, cfg)
    w, b = fused_mlp.pack_params([{k: v.to(DEVICE) for k, v in la.items()} for la in mlp["feat"]], skip)
    records = {}
    for n in (FINE_POINTS, RAGGED_POINTS):
        g = torch.Generator(device=DEVICE).manual_seed(n)
        points = torch.rand((n, 3), generator=g, device=DEVICE) * 6.0 - 3.0
        enc = pe.posenc_scene(points, cfg.L_3D, 1.0, cfg.barf_c2f).to(torch.bfloat16)
        enc = torch.nn.functional.pad(enc, (0, fused_mlp.in_pad(enc.shape[1]) - enc.shape[1])).contiguous()
        fwd = fused_mlp.trunk_fwd(enc, w, b, L, skip)
        fwd_ref = fused_mlp.trunk_fwd_plain(enc, w, b, L, skip)
        torch.cuda.synchronize()
        f_abs, f_rel = _max_err(fwd, fwd_ref)
        g_feat = (torch.randn((n, cfg.layers_feat[0]), generator=g, device=DEVICE) * 1e-3).to(torch.bfloat16)
        g_dens = (torch.randn(n, generator=g, device=DEVICE) * 1e-3).to(torch.bfloat16)
        feat, _, acts = fwd_ref
        bwd = fused_mlp.trunk_bwd(enc, g_feat, g_dens, feat, acts, w, b, L, skip)
        bwd_ref = fused_mlp.trunk_bwd_plain(enc, g_feat, g_dens, feat, acts, w, b, L, skip)
        torch.cuda.synchronize()
        b_abs, b_rel = _max_err(bwd, bwd_ref)
        print(f"trunk N={n}: fwd max abs err {f_abs:.3e} ({f_rel:.3e} of max |twin|), "
              f"bwd max abs err {b_abs:.3e} ({b_rel:.3e} of max |twin|), tolerance {REL_TOL} of max")
        if not (f_rel <= REL_TOL and b_rel <= REL_TOL):
            raise AssertionError(f"trunk kernel disagrees with its twin at N={n}")
        if n != FINE_POINTS:
            continue
        records = _trunk_records(fused_mlp, cfg, enc, w, b, L, skip, g_feat, g_dens, feat, acts, f_abs, b_abs)
        records["fwd"].update(_trunk_fwd_no_acts(fused_mlp, enc, w, b, L, skip, 2 * _trunk_macs(cfg) * n))
        records["bwd"].update(_trunk_bwd_parts(fused_mlp, enc, g_feat, g_dens, feat, acts, w, b, L, skip))
    return [records["fwd"], records["bwd"]]


def _trunk_records(fused_mlp, cfg, enc, w, b, L: int, skip: int, g_feat, g_dens, feat, acts, f_abs: float,
                   b_abs: float) -> dict:
    """{"fwd", "bwd"}: the kernel records of the instantiation that takes this
    trunk (`fused_mlp.kernel_name`), its forward and backward timed on these
    inputs beside their plain versions, with their bounds: the unpadded
    multiply-adds of `cfg`'s trunk, and each input read once and each output
    written once (the padded encoding, the weights, the stored activations)."""
    n, H, pad = enc.shape[0], feat.shape[1], enc.shape[1]
    ms = {
        "fwd": _time_ms(lambda: fused_mlp.trunk_fwd(enc, w, b, L, skip)),
        "fwd_plain": _time_ms(lambda: fused_mlp.trunk_fwd_plain(enc, w, b, L, skip)),
        "bwd": _time_ms(lambda: fused_mlp.trunk_bwd(enc, g_feat, g_dens, feat, acts, w, b, L, skip)),
        "bwd_plain": _time_ms(lambda: fused_mlp.trunk_bwd_plain(enc, g_feat, g_dens, feat, acts, w, b, L, skip)),
    }
    macs = _trunk_macs(cfg) * n
    wb = (w.numel() + b.numel()) * 2
    fwd_bytes = enc.numel() * 2 + wb + n * H * 2 + n * 4 + acts.numel() * 2
    bwd_bytes = (enc.numel() * 2 + g_feat.numel() * 2 + n * 2 + feat.numel() * 2 + acts.numel() * 2
                 + w.numel() * 2 + n * pad * 2 + (w.numel() + b.numel()) * 4)
    source = "fused_trunk.cu" if H in fused_mlp.WGMMA_WIDTHS else "trunk_wide.cu"
    # the 8x256 path has no yardstick; the narrow and wide cells print the library's products
    yardstick = {} if H == 256 else _cublas_layers_ms(fused_mlp, enc, w, b, L, skip, acts)
    records = {}
    for kind, flops, nbytes, err, line in (("fwd", 2 * macs, fwd_bytes, f_abs, 127),
                                           ("bwd", 4 * macs, bwd_bytes, b_abs, 284)):
        name = fused_mlp.kernel_name(kind, H, pad)
        bound_ms, bound_by = _bound(flops, nbytes)
        records[kind] = {
            "name": name, "route": "cuda", "source": f"poseprobe_tpu_torch/csrc/{source}",
            "replaces": f"poseprobe_tpu/ops/pallas/fused_mlp.py:{line}", "launches": 0,
            "max_abs_err": err, "ms": ms[kind], "plain_ms": ms[kind + "_plain"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
        if kind == "bwd" and H == fused_mlp.NARROW_WIDTH:
            # the chain is csrc/trunk_narrow.cu's, dW fused_trunk.cu's
            records[kind].update(source="poseprobe_tpu_torch/csrc/trunk_narrow.cu",
                                 dw_source=f"poseprobe_tpu_torch/csrc/{source}")
        print(f"{name} N={n} (H={H}, input pad {pad}): kernel {ms[kind]:.3f} ms, twin {ms[kind + '_plain']:.3f} ms, "
              f"bound {bound_ms:.3f} ms ({bound_by}: {flops / 1e12:.3f} TFLOP, {nbytes / 1e9:.3f} GB)")
        if yardstick:
            records[kind]["cublas_layers_ms"] = yardstick[kind]
            print(f"{name} N={n}: cublas_layers_ms {yardstick[kind]:.3f} (the layers' products through "
                  f"torch.addmm / torch.mm in bf16, summed; a yardstick, not a call computing the trunk)")
    return records


def _cublas_layers_ms(fused_mlp, enc, w, b, L: int, skip: int, acts) -> dict:
    """{"fwd", "bwd"}: the ms of the trunk's per-layer products through
    PyTorch's library calls in bf16, summed over the layers: the forward's
    `torch.addmm(b_l, inp_l, W_l)`, the backward's `torch.mm(g_l, W_l^T)` and
    `torch.mm(inp_l^T, g_l)` (inp_l the layer's input, the skip layer's
    concatenated beforehand; g_l a [n, NO_l] operand). No epilogue, mask,
    column sum or density dot: a yardstick for the wide kernels, which no
    single library call computes, so the records' `library_ms` stays null."""
    n, H, pad = enc.shape[0], acts.shape[2], enc.shape[1]
    lay = fused_mlp.layout(L, skip, H, pad)
    inps = [enc if l == 0 else (torch.cat([acts[l - 1], enc], 1) if l == skip else acts[l - 1]) for l in range(L)]
    Ws = [w[wo:wo + K * NO].view(K, NO) for K, NO, wo, _ in lay]
    bs = [b[bo:bo + NO] for _, NO, _, bo in lay]
    g = (torch.randn((n, H + fused_mlp.DENS_PAD), generator=torch.Generator(device=DEVICE).manual_seed(n),
                     device=DEVICE) * 1e-3).to(torch.bfloat16)

    def fwd():
        for x, W, bb in zip(inps, Ws, bs):
            torch.addmm(bb, x, W)

    def bwd():
        for x, W in zip(inps, Ws):
            gl = g[:, :W.shape[1]]
            torch.mm(gl, W.t())
            torch.mm(x.t(), gl)
    return {"fwd": _time_ms(fwd), "bwd": _time_ms(bwd)}


def _trunk_fwd_no_acts(fused_mlp, enc, w, b, L: int, skip: int, flops: float) -> dict:
    """The forward without stored activations (the visibility and eval
    renders): checked bit for bit against the stored call's feat and density,
    and timed. Also prints, each on its own line, this call's bound and the
    weight bytes the forward's blocks read from L2 in one call (every
    128-point block streams the packed trunk's 256 feature columns once)."""
    n = enc.shape[0]
    feat, dens, acts = fused_mlp.trunk_fwd(enc, w, b, L, skip)
    feat2, dens2, acts2 = fused_mlp.trunk_fwd(enc, w, b, L, skip, store_acts=False)
    torch.cuda.synchronize()
    if not (acts2 is None and torch.equal(feat2, feat) and torch.equal(dens2, dens)):
        raise AssertionError("trunk_fwd without stored activations differs from the stored call")
    ms = _time_ms(lambda: fused_mlp.trunk_fwd(enc, w, b, L, skip, store_acts=False))
    nbytes = float(enc.numel() * 2 + (w.numel() + b.numel()) * 2 + feat.numel() * 2 + dens.numel() * 4)
    bound_ms, bound_by = _bound(flops, nbytes)
    blocks = -(-n // 128)
    H = feat.shape[1]
    per_block = sum(K for K, *_ in fused_mlp.layout(L, skip, H, enc.shape[1])) * H * 2
    print(f"trunk_fwd N={n} without stored activations: kernel {ms:.3f} ms; bit-identical feat and density")
    print(f"trunk_fwd N={n} without stored activations: bound {bound_ms:.3f} ms "
          f"({bound_by}: {flops / 1e12:.3f} TFLOP, {nbytes / 1e9:.3f} GB)")
    print(f"trunk_fwd N={n}: weights read from L2 {blocks * per_block / 1e9:.3f} GB per call "
          f"({blocks} blocks x {per_block} B)")
    return {"no_acts_ms": ms}


def _trunk_bwd_parts(fused_mlp, enc, g_feat, g_dens, feat, acts, w, b, L: int, skip: int) -> dict:
    """The backward's two kernels timed apart on buffers made once. Also
    prints, on its own line, the floor of this two-kernel design: g written
    once by the chain and read once by dW, the stored activations read by
    both, the other inputs and outputs once, at the HBM rate."""
    n = enc.shape[0]
    out = fused_mlp._bwd_outputs(n, w, b, L, enc.shape[1])
    launch = lambda kernels: fused_mlp._bwd_launch(  # noqa: E731
        enc, g_feat, g_dens, feat, acts, w, out, L, skip, kernels)
    parts = {"chain_ms": _time_ms(lambda: launch(("chain",))), "dw_ms": _time_ms(lambda: launch(("dw",)))}
    nb = lambda t: float(t.numel() * t.element_size())  # noqa: E731
    denc, dw, db, gsave = out
    floor_bytes = (2 * nb(acts) + 2 * nb(gsave) + nb(g_feat) + nb(feat) + nb(g_dens) + 2 * nb(enc) + nb(w)
                   + nb(dw) + nb(db))
    print(f"trunk_bwd N={n} by kernel: chain {parts['chain_ms']:.3f} ms, dW {parts['dw_ms']:.3f} ms")
    if feat.shape[1] == fused_mlp.NARROW_WIDTH:
        plan = fused_mlp.narrow_plan(n, L, enc.shape[1], fused_mlp._sms(enc.device))
        print(f"trunk_bwd N={n}: the chain's plan {plan}")
    print(f"trunk_bwd N={n}: floor of the two-kernel design {floor_bytes / PEAK_HBM_BYTES * 1e3:.3f} ms "
          f"({floor_bytes / 1e9:.3f} GB at {PEAK_HBM_BYTES / 1e12:.2f} TB/s)")
    return parts


def check_posenc_kernels(pe, fused_mlp, scene_nerf) -> list:
    """The scene encoding's kernels (`csrc/posenc.cu`) against the plain chain
    (`posenc_scene`, the bf16 cast, the pad) at the main path's encoding (L 10,
    pad 64, the BARF window half open) for the mid fine render's points, a
    render chunk's and a ragged count: the forward bit for bit, the backward
    within 1e-5 of the sum of its terms' sizes. Returns the two records, timed
    at FINE_POINTS (device times from torch.profiler: the kernel alone, the
    wrapper with its BARF weights, the plain chain), with the render chunk's
    times beside them; the bound is the bytes (points read once, the tile
    written once; the backward reads the points and the tile and writes dx),
    and the sines and cosines a point (6 L) are recorded beside it."""
    cfg = scene_nerf.SceneConfig()
    L, barf, pad = cfg.L_3D, cfg.barf_c2f, fused_mlp.in_pad(cfg.input_3d_dim)
    progress = torch.tensor(0.5, device=DEVICE)
    times, b_abs = {}, 0.0
    for n in (FINE_POINTS, RENDER_CHUNK_POINTS, RAGGED_POINTS):
        g = torch.Generator(device=DEVICE).manual_seed(n)
        x = ((torch.rand((n, 3), generator=g, device=DEVICE) * 2.0 - 1.0) * 4.0).requires_grad_(True)
        denc = torch.randn((n, pad), generator=g, device=DEVICE).to(torch.bfloat16)
        enc = pe.posenc_scene_padded(x, L, progress, barf, pad)
        plain = pe.posenc_scene_padded_plain(x, L, progress, barf, pad)
        (dx,) = torch.autograd.grad(enc, x, denc, retain_graph=True)
        (dx_plain,) = torch.autograd.grad(plain, x, denc, retain_graph=True)
        torch.cuda.synchronize()
        differ = int((enc.view(torch.int16) != plain.view(torch.int16)).sum())
        w = pe.barf_weights(progress, L, barf, device=DEVICE)
        f = 2.0 ** torch.arange(L, dtype=torch.float32, device=DEVICE) * torch.pi
        d = denc.float()
        sizes = torch.stack([(w * f * d[:, 3 + c * 2 * L:3 + (c + 1) * 2 * L].abs().reshape(-1, 2, L).sum(1)).sum(-1)
                             for c in range(3)], dim=1) + d[:, :3].abs()
        err = float(((dx - dx_plain).abs() / sizes).max())
        print(f"posenc_scene N={n} (L {L}, pad {pad}): forward columns differing from the plain chain's {differ} "
              f"of {enc.numel()}; backward max |err| / sum of term sizes {err:.3e} (tolerance 1e-5)")
        if differ or not err <= 1e-5:
            raise AssertionError(f"the encoding kernels disagree with the plain chain at N={n}")
        b_abs = max(b_abs, float((dx - dx_plain).abs().max()))
        if n == RAGGED_POINTS:
            continue
        fwd = _device_profile(lambda: pe.posenc_scene_padded(x, L, progress, barf, pad))
        bwd = _device_profile(lambda: torch.autograd.grad(enc, x, denc, retain_graph=True))
        times[n] = {
            "fwd": next(ms for k, ms in fwd[2].items() if "posenc_scene_fwd" in k), "fwd_wrapper": fwd[0],
            "fwd_plain": _device_ms(lambda: pe.posenc_scene_padded_plain(x, L, progress, barf, pad)),
            "bwd": next(ms for k, ms in bwd[2].items() if "posenc_scene_bwd" in k), "bwd_wrapper": bwd[0],
            "bwd_plain": _device_ms(lambda: torch.autograd.grad(plain, x, denc, retain_graph=True)),
        }
    per_point = {"fwd": 12 + pad * 2, "bwd": 24 + pad * 2}       # bytes: points (and dx) and the bf16 tile
    records = []
    for kind, err in (("fwd", 0.0), ("bwd", b_abs)):
        t, c = times[FINE_POINTS], times[RENDER_CHUNK_POINTS]
        rec = _record(f"posenc_scene_{kind}", "posenc.cu", "none (poseprobe_tpu/ops/pe.py posenc_scene: XLA ops)",
                      err, t[kind], t[kind + "_plain"], 0.0, FINE_POINTS * per_point[kind], None)
        rec.update(wrapper_ms=t[kind + "_wrapper"], sincos_per_point=6 * L, L=L, pad=pad,
                   render_chunk_points=RENDER_CHUNK_POINTS, render_chunk_ms=c[kind],
                   render_chunk_wrapper_ms=c[kind + "_wrapper"], render_chunk_plain_ms=c[kind + "_plain"],
                   render_chunk_bound_ms=_bound(0.0, RENDER_CHUNK_POINTS * per_point[kind])[0])
        print(f"posenc_scene_{kind} at a render chunk's {RENDER_CHUNK_POINTS} points: kernel {c[kind]:.4f} ms, "
              f"wrapper {c[kind + '_wrapper']:.4f} ms, plain chain {c[kind + '_plain']:.4f} ms, bound "
              f"{rec['render_chunk_bound_ms']:.4f} ms (bytes)")
        records.append(rec)
    return records


def check_layout_kernels(layout, V: int, C: int, P: int) -> list:
    """The three layout kernels against their twins, bit for bit, at the
    grid's shapes and at ragged ones; records at the shapes the early step uses."""
    g = torch.Generator(device=DEVICE).manual_seed(1)
    rand = lambda *shape: torch.randn(shape, generator=g, device=DEVICE)  # noqa: E731
    src = "layout.cu"
    for shape in ((C, V), (V, C), (V, P), (1000, 77), (77, 1000), (100_003, 7), (33, 5), (1, 1)):
        x = rand(*shape)
        if not torch.equal(layout.transpose2d(x), layout.transpose2d_plain(x)):
            raise AssertionError(f"transpose2d differs from its twin at {shape}")
    for v, p, c in ((V, P, C), (V, 128, C), (100_003, P, C), (5000, 40, 33), (777, 4, 3), (10, 16, 16)):
        x = rand(v, p)
        if not torch.equal(layout.transpose_slice(x, c), layout.transpose_slice_plain(x, c)):
            raise AssertionError(f"transpose_slice differs from its twin at {(v, p, c)}")
    # a copy block moves 16 B x 256 threads = 4096 B: sizes around it and around 4 blocks (a bulk-ring
    # chunk); the designs `materialize` was chosen against are held to the twin at the same shapes
    lib, stream = layout._lib(), torch.cuda.current_stream().cuda_stream
    for shape, dtype in (((V, P), torch.float32), ((100_003, C), torch.float32), ((7,), torch.float32),
                         ((3, 5, 7, 11), torch.float32), ((4096 - 16,), torch.uint8), ((4096 + 16,), torch.uint8),
                         ((16384 - 16,), torch.uint8), ((16384,), torch.uint8), ((16384 + 16,), torch.uint8),
                         ((16385,), torch.uint8)):
        x = (rand(*shape) * 50).to(dtype)
        y = layout.materialize(x)
        if not (torch.equal(y, x) and y.data_ptr() != x.data_ptr()):
            raise AssertionError(f"materialize differs from its twin at {shape}")
        for design in MATERIALIZE_DESIGNS.values():
            y = torch.zeros_like(x)
            layout._check(lib, lib.materialize_design(x.data_ptr(), y.data_ptr(), x.numel() * x.element_size(),
                                                      design, stream), "materialize_design")
            if not torch.equal(y, x):
                raise AssertionError(f"materialize design {design} differs from the twin at {shape}")
    torch.cuda.synchronize()
    print("layout kernels and the materialize designs: bit-identical to their twins at every shape")
    # at the grid's shapes (the row layouts the TPU's gather and scatter worked on): [C, V] -> [V, C],
    # [V, P] -> [C, V];
    # four inputs in turn (184 to 226 MB in all, against 50 MB of L2), so the times are device-memory times
    xts, xss = [rand(C, V) for _ in range(4)], [rand(V, P) for _ in range(4)]
    nb = lambda t: float(t.numel() * t.element_size())  # noqa: E731
    timed = lambda fn, xs: _time_ms(_rotating(fn, xs), iters=12, warmup=4)  # noqa: E731
    return [
        _record("transpose2d", src, "poseprobe_tpu/ops/pallas/layout.py:110", 0.0,
                timed(layout.transpose2d, xts), timed(layout.transpose2d_plain, xts),
                0.0, nb(xts[0]) * 2, timed(lambda x: x.t().contiguous(), xts)),
        _record("transpose_slice", src, "poseprobe_tpu/ops/pallas/layout.py:43", 0.0,
                timed(lambda x: layout.transpose_slice(x, C), xss),
                timed(lambda x: layout.transpose_slice_plain(x, C), xss),
                0.0, nb(xss[0]) + V * C * 4.0, timed(lambda x: x[:, :C].t().contiguous(), xss)),
        _materialize_record(layout, src, xss, timed, nb(xss[0]) * 2),
    ]


def _materialize_record(layout, src: str, xs, timed, nbytes: float) -> dict:
    """The copy kernel against one PyTorch copy on the same rotating inputs,
    each reading the mean of two taken in turns (forward, then backward
    order): `ms` the wrapper (allocation, checks, launch) against `x.clone()`
    (`library_ms`); `kernel_ms` its bare launches into preallocated outputs
    against `y.copy_(x)` into the same outputs (`copy_ms`), and beside them
    the bare launches of the other designs (`designs_ms`)."""
    lib, stream = layout._lib(), torch.cuda.current_stream().cuda_stream
    pairs = list(zip(xs, [torch.empty_like(x) for x in xs]))
    half = int(nbytes // 2)
    bare = lambda pair: layout._check(lib, lib.materialize(  # noqa: E731
        pair[0].data_ptr(), pair[1].data_ptr(), half, stream), "materialize")
    design = lambda d: lambda pair: layout._check(lib, lib.materialize_design(  # noqa: E731
        pair[0].data_ptr(), pair[1].data_ptr(), half, d, stream), "materialize_design")
    runs = [("wrapper", layout.materialize, xs), ("clone", lambda x: x.clone(), xs),
            ("kernel", bare, pairs), ("copy_", lambda pair: pair[1].copy_(pair[0]), pairs)]
    runs += [(name, design(d), pairs) for name, d in MATERIALIZE_DESIGNS.items()]
    t = {name: [] for name, _, _ in runs}
    for order in (runs, runs[::-1]):
        for name, fn, ins in order:
            t[name].append(timed(fn, ins))
    print("materialize in turns (forward, backward order): "
          + ", ".join(f"{k} {v[0]:.4f} / {v[1]:.4f}" for k, v in t.items()) + " ms")
    mean = {k: sum(v) / 2 for k, v in t.items()}
    rec = _record("materialize", src, "poseprobe_tpu/ops/pallas/layout.py:73", 0.0, mean["wrapper"],
                  timed(layout.materialize_plain, xs), 0.0, nbytes, mean["clone"])
    rec.update(kernel_ms=mean["kernel"], copy_ms=mean["copy_"],
               designs_ms={name: mean[name] for name in MATERIALIZE_DESIGNS})
    print(f"materialize bare launches {rec['kernel_ms']:.4f} ms against y.copy_(x) {rec['copy_ms']:.4f} ms; designs "
          + ", ".join(f"{k} {v:.4f}" for k, v in rec["designs_ms"].items()) + " ms")
    if rec["ms"] > rec["library_ms"]:
        print(f"note: materialize {rec['ms']:.4f} ms is slower than x.clone() {rec['library_ms']:.4f} ms in this call")
    return rec


def _device_ms(fn, iters: int = 20, flush: bool = False) -> float:
    """Mean device time of one call of `fn` (its kernels, copies and memsets)
    under torch.profiler; see `_device_profile`."""
    return _device_profile(fn, iters, flush)[0]


def _device_profile(fn, iters: int = 20, flush: bool = False) -> tuple[float, float, dict]:
    """(device ms, device events, {event name: device ms}) per call of `fn`,
    under torch.profiler: its kernels, copies and memsets. With `flush`, a
    copy of 2 x 64 MB (more than the 50 MB L2) runs before each call and is
    left out. Each window opens with a warmup phase of five calls whose events
    are discarded: late in long runs the trace dropped the first kernels
    launched after the profiler started. A window in which the profiler lost
    device events all the same (none, or a count that is not the same for
    every call) is measured again, at most twenty times in all; then the call
    fails, naming what each window returned."""
    def calls(n):
        for _ in range(n):
            if flush:
                _FLUSH[1].copy_(_FLUSH[0])
            fn()
        torch.cuda.synchronize()

    calls(3)
    lost = []
    for _ in range(20):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                    schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            calls(5)
            prof.step()
            calls(iters)
            prof.step()
        events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0 and not (flush and "Memcpy" in e.key)
                  and not getattr(e, "is_user_annotation", False)]      # the program's spans
        if events and all(e.count % iters == 0 for e in events):
            if lost:
                print(f"note: torch.profiler lost device events in {len(lost)} window(s) before this one: "
                      + "; ".join(lost))
            by_name = {e.key: e.self_device_time_total / 1e3 / iters for e in events}
            return sum(by_name.values()), sum(e.count for e in events) / iters, by_name
        lost.append(", ".join(f"{e.key[:40]} x{e.count}" for e in events) or "no device event")
    raise AssertionError(f"torch.profiler lost device events in twenty windows of {iters} calls: " + "; ".join(lost))


_FLUSH: list = []


def _trilinear_case(grid_ops, G: int, C: int, N: int, lo, hi, seed: int):
    """A random [C, G, G, G] grid and N points: inside, outside, on voxel
    corners and on the border; cotangents for value and gradient."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    grid = torch.randn((C, G, G, G), generator=g, device=DEVICE)
    pts = torch.rand((N, 3), generator=g, device=DEVICE) * (hi - lo) * 1.2 + lo - 0.1 * (hi - lo)
    n8 = N // 8
    ijk = torch.randint(0, G, (n8, 3), generator=g, device=DEVICE).float()
    pts[:n8] = lo + ijk / (G - 1.0) * (hi - lo)                      # voxel corners, faces included
    pick = torch.rand((n8, 3), generator=g, device=DEVICE) < 0.5
    pts[n8:2 * n8] = torch.where(pick, lo.expand(n8, 3), hi.expand(n8, 3))   # box corners
    ct_v = torch.randn((N, C), generator=g, device=DEVICE)
    ct_g = torch.randn((N, C, 3), generator=g, device=DEVICE)
    return grid, pts.contiguous(), ct_v, ct_g


def _tri_close(name: str, out: torch.Tensor, ref: torch.Tensor) -> float:
    err = float((out - ref).abs().max())
    if not err <= TRI_REL_TOL * float(ref.abs().max()) + TRI_ABS_TOL:
        raise AssertionError(f"{name}: max abs err {err:.3e} against max |twin| {float(ref.abs().max()):.3e}")
    return err


CAPTURED: dict = {}                     # lookup points by capture label, for --lookup-points


@contextlib.contextmanager
def _capturing(fused_mlp, grid_ops, calls: list, lookups: list):
    """Appends the trunk calls [(enc, w, b, L, skip)] and the grid lookups
    [(grid shape, with_grad, points [N, 3], lo, hi)] made inside the block,
    each with its own inputs, for `_hold_captured`."""
    trunk_fwd = fused_mlp.trunk_fwd
    kernels = grid_ops.trilinear_sample, grid_ops.trilinear_sample_with_grad

    def watch_trunk(enc, w, b, L, skip, store_acts=True):
        calls.append((enc.detach().clone(), w.detach().clone(), b.detach().clone(), L, skip))
        return trunk_fwd(enc, w, b, L, skip, store_acts)

    def watch(fn, with_grad):
        def call(grid, xyz, lo, hi):
            bound = lambda v: torch.as_tensor(v, device=xyz.device).detach().float().clone()  # noqa: E731
            lookups.append((tuple(grid.shape), with_grad, xyz.detach().reshape(-1, 3).clone(), bound(lo), bound(hi)))
            return fn(grid, xyz, lo, hi)
        return call

    fused_mlp.trunk_fwd = watch_trunk
    grid_ops.trilinear_sample, grid_ops.trilinear_sample_with_grad = watch(kernels[0], False), watch(kernels[1], True)
    try:
        yield
    finally:
        fused_mlp.trunk_fwd = trunk_fwd
        grid_ops.trilinear_sample, grid_ops.trilinear_sample_with_grad = kernels


def capture_lookup_points(grid_ops, tr, label: str) -> list:
    """The points of every grid lookup of the joint trainer's next step, in
    call order: [(grid shape, with_grad, points [N, 3], lo, hi)]; kept in
    CAPTURED[label]."""
    from poseprobe_tpu_torch.ops import fused_mlp
    seen = []
    with _capturing(fused_mlp, grid_ops, [], seen):
        tr.step()
    torch.cuda.synchronize()
    print(f"lookups of step {tr.global_step - 1} ({label}) captured: "
          + ", ".join(f"grid {list(gs)}{' value+grad' if wg else ''}: {p.shape[0]} points" for gs, wg, p, _, _ in seen))
    CAPTURED[label] = seen
    return seen


def _grid_sample_coords(grid_ops, pts, lo, hi):
    """The points as F.grid_sample takes them: [-1, 1] in (z, y, x) order, [1, 1, 1, N, 3]."""
    return (2.0 * grid_ops.normalize_coords(pts, lo, hi) - 1.0)[:, [2, 1, 0]].reshape(1, 1, 1, -1, 3).contiguous()


def _row_pad(C: int) -> int:
    """Width of a 16-byte aligned [V, P] row buffer for C channels (`transpose_slice`'s input)."""
    return -(-C // 4) * 4


def _lookup_times(grid_ops, grid, pts, lo, hi, ct_v, ct_g, with_grad: bool, flush: bool) -> dict:
    """Device ms of the whole lookup from the [C, X, Y, Z] grid, forward (the
    gather) and backward (zero-fill + the scatter, d_pts too with the
    gradient), beside F.grid_sample (value only) and its autograd backward,
    in turns (the port's, the library's, then the reverse order); and the
    scatter kernel alone."""
    C, V = grid.shape[0], grid[0].numel()
    cg = ct_g if with_grad else None
    coords = _grid_sample_coords(grid_ops, pts, lo, hi)
    gl = grid.clone().requires_grad_(True)
    out_l = torch.nn.functional.grid_sample(gl[None], coords, mode="bilinear", padding_mode="border", align_corners=True)
    ct_l = ct_v.t().reshape(1, C, 1, 1, -1).contiguous()
    d_grid = torch.zeros_like(grid)
    d_pts = torch.empty_like(pts) if with_grad else None
    lib, ptr = grid_ops._lib(), grid_ops._ptr
    stream = torch.cuda.current_stream().cuda_stream
    X, Y, Z = grid.shape[1:]
    fns = {
        "fwd": lambda: grid_ops.trilinear_fwd(grid, pts, lo, hi, with_grad),
        "lib_fwd": lambda: torch.nn.functional.grid_sample(grid[None], coords, mode="bilinear", padding_mode="border",
                                                           align_corners=True),
        "bwd": lambda: grid_ops.trilinear_bwd(grid, pts, lo, hi, ct_v, cg, True, with_grad),
        "lib_bwd": lambda: torch.autograd.grad(out_l, gl, ct_l, retain_graph=True),
        # the scatter kernel alone, into a buffer zeroed once (its sums grow; only its time is read)
        "scatter": lambda: grid_ops._check(lib, lib.trilinear_bwd(
            ptr(grid), ptr(pts), ptr(lo), ptr(hi), ptr(ct_v), ptr(cg), X, Y, Z, C, pts.shape[0], ptr(d_grid),
            None, None, ptr(d_pts), stream), "trilinear_bwd"),
    }
    t = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            t[k].append(_device_ms(fns[k], flush=flush))
    return {k: sum(v) / 2 for k, v in t.items()} | {k + "_turns": v for k, v in t.items()}


def time_lookups(grid_ops, sets) -> dict:
    """`_lookup_times` for each (name, grid shape, with_grad, points, lo, hi)
    of `sets` on a random grid of that shape, L2 warm and flushed; printed,
    and returned by (name, C, flush)."""
    times = {}
    for set_name, gs, with_grad, p, l, h in sets:
        C = gs[0]
        g = torch.Generator(device=DEVICE).manual_seed(C)
        grid_c = torch.randn(gs, generator=g, device=DEVICE)
        cv = torch.randn((p.shape[0], C), generator=g, device=DEVICE)
        cgr = torch.randn((p.shape[0], C, 3), generator=g, device=DEVICE)
        for flush in (False, True):
            t = _lookup_times(grid_ops, grid_c, p, l, h, cv, cgr, with_grad, flush)
            times[(set_name, C, flush)] = t
            print(f"lookup from the grid {list(gs)}, {set_name} points (N={p.shape[0]})"
                  f"{' value+grad' if with_grad else ''}, L2 {'flushed' if flush else 'warm'}, device ms (mean of "
                  f"two turns): forward {t['fwd']:.4f}, F.grid_sample {t['lib_fwd']:.4f}; backward {t['bwd']:.4f} "
                  f"(scatter alone {t['scatter']:.4f}), grid_sample backward {t['lib_bwd']:.4f}; turns "
                  + json.dumps({k: [round(x, 4) for x in v] for k, v in t.items() if k.endswith("_turns")}))
    return times


def check_trilinear_kernels(grid_ops, G: int, n_path: int, n_full: int, early: list) -> list:
    """trilinear_fwd / trilinear_bwd against the autograd twin (nested lerps)
    for C = 1 with gradient and C = 13 value-only; the whole lookup from the
    grid timed beside F.grid_sample at uniform points and at the points of
    each of the early step's lookups (`early`, from `capture_lookup_points`),
    L2 warm and flushed; records for the 13-channel lookup at the early step's
    point count `n_path`."""
    lo = torch.tensor([-0.5, -0.45, -0.55], device=DEVICE)
    hi = torch.tensor([0.5, 0.55, 0.45], device=DEVICE)
    _FLUSH[:] = [torch.empty(2 ** 24, device=DEVICE), torch.empty(2 ** 24, device=DEVICE)]
    worst = {"fwd": 0.0, "bwd": 0.0}
    for C, with_grad in ((1, True), (13, False)):
        for N in (n_path, n_full, RAGGED_POINTS):
            grid, pts, ct_v, ct_g = _trilinear_case(grid_ops, G, C, N, lo, hi, seed=C * 1000 + N % 997)
            gk, pk = grid.clone().requires_grad_(True), pts.clone().requires_grad_(True)
            gt, pt = grid.clone().requires_grad_(True), pts.clone().requires_grad_(True)
            if with_grad:
                outs = grid_ops.trilinear_sample_with_grad(gk, pk, lo, hi)
                refs = grid_ops.trilinear_vg_reference(gt, pt, lo, hi)
                cts = [ct_v, ct_g]
            else:
                outs = [grid_ops.trilinear_sample(gk, pk, lo, hi)]
                refs = [grid_ops.trilinear_sample_reference(gt, pt, lo, hi)]
                cts = [ct_v]
            torch.autograd.backward(list(outs), cts)
            torch.autograd.backward(list(refs), cts)
            torch.cuda.synchronize()
            f_err = max(_tri_close(f"trilinear_fwd C={C} N={N}", o.detach(), r.detach())
                        for o, r in zip(outs, refs))
            b_err = max(_tri_close(f"trilinear_bwd d_grid C={C} N={N}", gk.grad, gt.grad),
                        _tri_close(f"trilinear_bwd d_pts C={C} N={N}", pk.grad, pt.grad))
            worst = {"fwd": max(worst["fwd"], f_err), "bwd": max(worst["bwd"], b_err)}
            print(f"trilinear C={C} N={N} {'value+grad' if with_grad else 'value'}: fwd max abs err "
                  f"{f_err:.3e}, bwd max abs err {b_err:.3e} (tolerance {TRI_REL_TOL} of max |twin| "
                  f"+ {TRI_ABS_TOL})")

    # the kernels against their plain versions on the same inputs, at the early step's shapes
    for C, with_grad in ((13, False), (1, True)):
        grid, pts, ct_v, ct_g = _trilinear_case(grid_ops, G, C, n_path, lo, hi, seed=C + 7)
        cg = ct_g if with_grad else None
        pairs = list(zip(grid_ops.trilinear_fwd(grid, pts, lo, hi, with_grad),
                         grid_ops.trilinear_fwd_plain(grid, pts, lo, hi, with_grad)))
        bpairs = list(zip(grid_ops.trilinear_bwd(grid, pts, lo, hi, ct_v, cg, True, with_grad),
                          grid_ops.trilinear_bwd_plain(grid, pts, lo, hi, ct_v, cg, True, with_grad)))
        torch.cuda.synchronize()
        worst["fwd"] = max([worst["fwd"]] + [_tri_close(f"trilinear_fwd C={C} against its plain version", a, b)
                                             for a, b in pairs if a is not None])
        worst["bwd"] = max([worst["bwd"]] + [_tri_close(f"trilinear_bwd C={C} against its plain version", a, b)
                                             for a, b in bpairs if a is not None])
    print(f"trilinear kernels against the twin and their plain versions: worst abs err fwd {worst['fwd']:.3e}, "
          f"bwd {worst['bwd']:.3e}")

    # records at the early step's shapes
    gshape = (13, G, G, G)
    grid, pts, ct_v, ct_g = _trilinear_case(grid_ops, G, 13, n_path, lo, hi, seed=5)
    idx8 = grid_ops._corner_data(gshape, pts, lo, hi)[0]
    n_rows = float(torch.unique(idx8).numel())                    # the rows this run's points need
    N, V = float(n_path), float(G ** 3)
    gt = grid.clone().requires_grad_(True)
    out_t = grid_ops.trilinear_sample_reference(gt, pts, lo, hi)
    d_twin, = torch.autograd.grad(out_t, gt, ct_v, retain_graph=True)

    # the library's call for the same function: grid_sample on a 5-D input, border padding,
    # align_corners, coordinates normalised to [-1, 1] in (z, y, x) order; its autograd backward
    # is the library's scatter. Timed here and held against the twin; the port never calls it.
    coords = _grid_sample_coords(grid_ops, pts, lo, hi)
    gl = grid.clone().requires_grad_(True)
    out_l = torch.nn.functional.grid_sample(gl[None], coords, mode="bilinear", padding_mode="border",
                                            align_corners=True)            # [1, C, 1, 1, N]
    ct_l = ct_v.t().reshape(1, 13, 1, 1, -1).contiguous()
    d_lib, = torch.autograd.grad(out_l, gl, ct_l, retain_graph=True)
    l_err = max(_tri_close("grid_sample value", out_l.detach()[0, :, 0, 0].t(), out_t.detach()),
                _tri_close("grid_sample d_grid", d_lib, d_twin))
    print(f"library call (F.grid_sample and its backward) against the twin: max abs err {l_err:.3e}")

    # the staged scatter of POSEPROBE_SCATTER_BARRIER=1 (updates written out, passed through
    # `materialize`, added by the second kernel) against the twin and the direct scatter
    d_direct, _ = grid_ops.trilinear_bwd(grid, pts, lo, hi, ct_v, None, True, False)
    before = grid_ops.layout.materialize_launches
    os.environ["POSEPROBE_SCATTER_BARRIER"] = "1"
    try:
        d_staged, _ = grid_ops.trilinear_bwd(grid, pts, lo, hi, ct_v, None, True, False)
        staged_ms = _device_ms(lambda: grid_ops.trilinear_bwd(grid, pts, lo, hi, ct_v, None, True, False))
    finally:
        os.environ.pop("POSEPROBE_SCATTER_BARRIER")
    if grid_ops.layout.materialize_launches == before:
        raise AssertionError("the staged scatter did not pass through materialize")
    s_err = max(_tri_close("staged d_grid against the twin", d_staged, d_twin),
                _tri_close("staged d_grid against the direct scatter", d_staged, d_direct),
                _tri_close("direct d_grid against the twin", d_direct, d_twin))
    print(f"trilinear_bwd C=13 N={n_path} with POSEPROBE_SCATTER_BARRIER=1 (materialize + scatter_rows): "
          f"d_grid max abs err {s_err:.3e} against the twin and the direct scatter, {staged_ms:.4f} device ms")

    # the whole lookup from the grid, at uniform points and at each early-step lookup's own points
    sets = [("uniform", (13, G, G, G), False, pts, lo, hi), ("uniform", (1, G, G, G), True, pts, lo, hi)]
    sets += [(f"early lookup {i}", gs, wg, p, l, h) for i, (gs, wg, p, l, h) in enumerate(early)]
    times = time_lookups(grid_ops, sets)
    t, tf = times[("uniform", 13, False)], times[("uniform", 13, True)]

    # `ms` is the whole function from the grid, as the twin and the library compute it: forward the
    # gather straight from the grid; backward zero-fill + scatter (the merged 13-channel lookup's
    # backward on the path is d_grid only: its points carry no gradient). `kernel_ms`: the scatter
    # kernel alone.
    dev = lambda fn: _device_ms(fn)  # noqa: E731
    fwd = _record(
        "trilinear_fwd", "trilinear.cu", "poseprobe_tpu/ops/grid.py:255", worst["fwd"], t["fwd"],
        dev(lambda: grid_ops.trilinear_sample_reference(grid, pts, lo, hi)),
        N * 13 * 8 * 3, n_rows * 13 * 4 + N * 12 + N * 13 * 4, t["lib_fwd"], PEAK_F32_FLOPS)
    fwd.update(flushed_ms=tf["fwd"], library_flushed_ms=tf["lib_fwd"])
    bwd = _record(
        "trilinear_bwd", "trilinear.cu", "poseprobe_tpu/ops/grid.py:269", max(worst["bwd"], s_err), t["bwd"],
        dev(lambda: torch.autograd.grad(out_t, gt, ct_v, retain_graph=True)),
        N * 13 * 8 * 4, N * 12 + N * 13 * 4 + V * 13 * 4, t["lib_bwd"], PEAK_F32_FLOPS)
    bwd.update(kernel_ms=t["scatter"], flushed_ms=tf["bwd"], library_flushed_ms=tf["lib_bwd"], staged_ms=staged_ms,
               kernel_bound_ms=_bound(N * 13 * 8 * 4, N * 12 + N * 13 * 4 + n_rows * 13 * 4, PEAK_F32_FLOPS)[0])
    print(f"trilinear records at C=13, N={n_path} (uniform points, L2 warm, device times by torch.profiler): "
          f"scatter alone {bwd['kernel_ms']:.4f} ms (bound {bwd['kernel_bound_ms']:.4f} ms: cotangents, points and "
          f"{int(n_rows)} touched voxels of 13 channels)")
    return [fwd, bwd]


def _composite_case(N: int, S: int, inv_s: float, dist: float, seed: int):
    """Rays that start outside the surface and walk into it (the SDF falls by
    |cos| * dist per sample, plus noise), with rays that never reach it, rays
    deep inside from the first sample (alpha = 1, T falls to 1e-10), grazing
    rays (alpha ~ 0), masked samples and wholly masked rays; cotangents for
    the four outputs."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    rand = lambda *shape: torch.rand(shape, generator=g, device=DEVICE)  # noqa: E731
    cos_term = -rand(N, S) * (rand(N, 1) > 0.1)                    # a tenth of the rays graze: cos = 0
    # some rays start inside; rays longer than the tile start far enough out to meet the surface anywhere
    start = rand(N, 1) * (0.6 if S <= COMPOSITE_TILE else 0.5 * dist * S) - 0.1
    sdf = start + torch.cumsum(cos_term * dist, dim=1) + (rand(N, S) - 0.5) * 0.2 * dist
    mask = rand(N, S) > 0.15
    mask[: N // 16] = False                                        # wholly masked rays
    mask[N // 16: N // 8, S // 2:] = False                         # rays that leave the box early
    rgb = rand(N, S, 3)
    step = (torch.arange(S, device=DEVICE, dtype=torch.float32) * dist + rand(N, 1) * dist).contiguous()
    scalars = torch.tensor([inv_s, dist], device=DEVICE)
    randn = lambda *shape: torch.randn(shape, generator=g, device=DEVICE)  # noqa: E731
    cts = (randn(N, S), randn(N), randn(N, 3), randn(N))
    return (sdf.contiguous(), cos_term.contiguous(), mask, rgb, step, scalars), cts


def check_composite_kernels(fused_composite, compositing, n_rays: int, K: int, n_samples: int) -> list:
    """composite_fwd / composite_bwd against the plain version (and its
    autograd) at the early step's shape [n_rays, K], at the dense
    [n_rays, n_samples], at a ragged shape, for a soft and a sharp inv_s;
    records at [n_rays, K]. Rays with a sample whose transmittance lies within
    1e-4 (relative) of the early-termination threshold are left out of the
    comparison: the warp scan and cumprod round T differently there, and the
    gate is a step."""
    out_tol, grad_rel, grad_abs = 1e-5, 1e-4, 1e-6
    dist = 0.0125
    worst = {"fwd": 0.0, "bwd": 0.0, "fwd_chunked": 0.0, "bwd_chunked": 0.0}
    for N, S in ((n_rays, K), (n_rays, n_samples), (1000, 7), (37, 1000), (n_rays, CHUNKED_S[0]),
                 (n_rays, LONG_RAY_K), (n_rays, CHUNKED_S[1]), (256, CHUNKED_S[2]), (128, CHUNKED_S[3])):
        for inv_s in (20.0, 2000.0):
            args, cts = _composite_case(N, S, inv_s, dist, seed=N * 7 + S)
            outs = fused_composite.composite_fwd(*args)
            refs = fused_composite.fused_alpha_composite_plain(*args[:5], args[5][0], args[5][1])
            grads = fused_composite.composite_bwd(*args, *cts)
            grefs = fused_composite.composite_bwd_plain(*args, *cts)
            torch.cuda.synchronize()
            alpha = torch.where(args[2], compositing.neus_alpha_from_sdf(
                torch.ones(1, device=DEVICE), dist, args[0], args[1][..., None], 1.0 / inv_s), 0.0)
            om = torch.clamp(1.0 - alpha, 1e-10, 1.0)
            T = torch.cumprod(torch.cat([torch.ones_like(om[:, :1]), om[:, :-1]], dim=1), dim=1)
            keep = ~((T / 1e-3 - 1.0).abs() < 1e-4).any(dim=1)
            if not all(bool(torch.isfinite(t).all()) for t in (*outs, *grads)):
                raise AssertionError(f"composite kernels: non-finite values at N={N} S={S} inv_s={inv_s}")
            # past the tile the kernel's transmittance (runs, block scans, stage carries) and the plain cumprod round
            # a product of up to S float32 factors in other orders: each output is held to S x 2^-24 (the bound
            # on that rounding, relative) of its largest value where that exceeds 1e-5 (n_step reaches S * dist)
            f_errs = [float((o[keep] - r[keep]).abs().max()) for o, r in zip(outs, refs)]
            f_tols = [max(out_tol, S * 2.0 ** -24 * float(r[keep].abs().max())) if S > COMPOSITE_TILE else out_tol
                      for r in refs]
            f_err, f_ok = max(f_errs), all(e <= t for e, t in zip(f_errs, f_tols))
            b_err, b_ok = 0.0, True
            for name, o, r in zip(("d_sdf", "d_cos", "d_rgb", "d_step"), grads[:4], grefs[:4]):
                err = float((o[keep] - r[keep]).abs().max())
                b_err = max(b_err, err)
                b_ok &= err <= grad_rel * float(r[keep].abs().max()) + grad_abs
            if bool(keep.all()):
                # the scalar gradients sum over every ray, so they compare only when none is left out
                err = float((grads[4] - grefs[4]).abs().max())
                b_err = max(b_err, err)
                b_ok &= err <= grad_rel * float(grefs[4].abs().max()) + grad_abs * N * S
            print(f"composite N={N} S={S} inv_s={inv_s:g}: fwd max abs err {f_err:.3e} (tolerance {max(f_tols):.3e}), "
                  f"bwd max abs err {b_err:.3e} (tolerance {grad_rel} of max |plain| + {grad_abs}), "
                  f"{int((~keep).sum())} rays at the gate left out")
            if not (f_ok and b_ok):
                raise AssertionError(f"composite kernel disagrees with its plain version at N={N} S={S} "
                                     f"inv_s={inv_s}")
            if (N, S) == (n_rays, K):
                worst.update(fwd=max(worst["fwd"], f_err), bwd=max(worst["bwd"], b_err))
            if S > COMPOSITE_TILE:
                worst.update(fwd_chunked=max(worst["fwd_chunked"], f_err), bwd_chunked=max(worst["bwd_chunked"], b_err))

    args, cts = _composite_case(n_rays, K, 20.0, dist, seed=11)
    ns = float(n_rays * K)
    src, line = "fused_composite.cu", "poseprobe_tpu/ops/pallas/fused_composite.py:84"
    if not _FLUSH:
        _FLUSH[:] = [torch.empty(2 ** 24, device=DEVICE), torch.empty(2 ** 24, device=DEVICE)]
    fns = _composite_bare(fused_composite, args, cts) | {
        "fwd_wrapper": lambda: fused_composite.composite_fwd(*args),
        "bwd_wrapper": lambda: fused_composite.composite_bwd(*args, *cts),
    }
    # device times in turns (forward order, then backward), L2 warm; the kernels also flushed
    t = {k: [] for k in fns}
    events = {}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            ms, events[k], _ = _device_profile(fns[k])
            t[k].append(ms)
    dev = {k: sum(v) / 2 for k, v in t.items()}
    flushed = {k: _device_ms(fns[k], flush=True) for k in ("fwd_kernel", "bwd_kernel")}
    # the autograd entry the renderer calls, forward + backward: its device events per call
    leaves = [a.clone().requires_grad_(True) for a in (args[0], args[1], args[3], args[4])]
    entry = lambda: torch.autograd.grad(fused_composite.fused_alpha_composite(  # noqa: E731
        leaves[0], leaves[1], args[2], leaves[2], leaves[3], 20.0, dist), leaves, cts)
    _, entry_events, _ = _device_profile(entry)
    plain_fwd = lambda: fused_composite.fused_alpha_composite_plain(*args[:5], args[5][0], args[5][1])  # noqa: E731
    records = [
        # forward: sdf, cos, step, rgb (24 B) + mask (1 B) read, the weight written, per sample;
        # two sigmoids, a quotient, the scan and four multiply-adds: ~60 operations
        _record("composite_fwd", src, line, worst["fwd"], dev["fwd_kernel"], _device_ms(plain_fwd),
                ns * 60, ns * 29 + n_rays * 20, None, PEAK_F32_FLOPS),
        # backward: the same inputs and the weight cotangent read (29 B), d_sdf, d_cos, d_step,
        # d_rgb written (24 B), per sample; the forward's operations again plus the reverse scan
        _record("composite_bwd", src, line, worst["bwd"], dev["bwd_kernel"],
                _device_ms(lambda: fused_composite.composite_bwd_plain(*args, *cts)),
                ns * 120, ns * 53 + n_rays * 28, None, PEAK_F32_FLOPS),
    ]
    # `ms` and `kernel_ms`: the bare launch's device time (torch.profiler), L2 warm; `wrapper_ms` and
    # `wrapper_launches`: the wrapper's device time and device events per call (allocations, the launch
    # and, backward, the sum of the partials); `enqueue_loop_ms`: 200 bare launches back to back between
    # two CUDA events, each checked on the host, which measures the host's enqueue rate at this size
    for rec, d in zip(records, ("fwd", "bwd")):
        rec.update(kernel_ms=dev[f"{d}_kernel"], kernel_flushed_ms=flushed[f"{d}_kernel"],
                   kernel_turns_ms=t[f"{d}_kernel"], wrapper_ms=dev[f"{d}_wrapper"],
                   wrapper_launches=events[f"{d}_wrapper"],
                   enqueue_loop_ms=_time_ms(fns[f"{d}_kernel"], iters=200))
        print(f"{rec['name']}: kernel device {rec['kernel_ms']:.5f} ms (turns {t[f'{d}_kernel']}, flushed "
              f"{rec['kernel_flushed_ms']:.5f}), wrapper device {rec['wrapper_ms']:.5f} ms in "
              f"{rec['wrapper_launches']:g} device events per call, host-enqueue-bound launch loop "
              f"{rec['enqueue_loop_ms']:.5f} ms")
    print(f"fused_alpha_composite forward + backward: {entry_events:g} device events per call")

    # past the tile: the ray kernels' bare launches at [n_rays, 2048] (the records) and at the long-ray
    # step's [n_rays, LONG_RAY_K], in turns (forward, backward, backward, forward), L2 warm; also flushed
    ray = {}
    for S in (CHUNKED_S[1], LONG_RAY_K):
        args, cts = _composite_case(n_rays, S, 20.0, dist, seed=12)
        fns = _composite_bare(fused_composite, args, cts)
        ns = float(n_rays * S)
        turns = {"fwd": [], "bwd": []}
        for d in ("fwd", "bwd", "bwd", "fwd"):
            turns[d].append(_device_ms(fns[f"{d}_kernel"]))
        plain = {"fwd": lambda: fused_composite.fused_alpha_composite_plain(*args[:5], args[5][0], args[5][1]),
                 "bwd": lambda: fused_composite.composite_bwd_plain(*args, *cts)}
        ray[S] = {d: {"kernel_ms": sum(turns[d]) / 2, "kernel_turns_ms": turns[d],
                      "kernel_flushed_ms": _device_ms(fns[f"{d}_kernel"], flush=True), "plain_ms": _device_ms(plain[d]),
                      # forward 29 B a sample and 20 a ray, backward 53 and 28 (as the tiled records)
                      "bound_ms": _bound(ns * (60 if d == "fwd" else 120),
                                         ns * (29 if d == "fwd" else 53) + n_rays * (20 if d == "fwd" else 28),
                                         PEAK_F32_FLOPS)[0]} for d in turns}
        for d, r in ray[S].items():
            print(f"composite_{d}_chunked at [{n_rays}, {S}]: bare launch {r['kernel_ms']:.5f} ms in turns "
                  f"{r['kernel_turns_ms']}, flushed {r['kernel_flushed_ms']:.5f}, bound {r['bound_ms']:.5f} "
                  f"({r['bound_ms'] / r['kernel_ms']:.0%} of it), plain {r['plain_ms']:.4f} ms")
    S, ns = CHUNKED_S[1], float(n_rays * CHUNKED_S[1])
    for d, flops, nbytes in (("fwd", ns * 60, ns * 29 + n_rays * 20), ("bwd", ns * 120, ns * 53 + n_rays * 28)):
        r = ray[S][d]
        rec = _record(f"composite_{d}_chunked", src, line, worst[f"{d}_chunked"], r["kernel_ms"], r["plain_ms"], flops,
                      nbytes, None, PEAK_F32_FLOPS)
        rec.update(kernel_ms=r["kernel_ms"], kernel_turns_ms=r["kernel_turns_ms"],
                   kernel_flushed_ms=r["kernel_flushed_ms"], shape=[n_rays, S],
                   at_long_ray_k={"shape": [n_rays, LONG_RAY_K], **ray[LONG_RAY_K][d]})
        records.append(rec)
    return records


def _composite_bare(fused_composite, args, cts) -> dict:
    """{"fwd_kernel", "bwd_kernel"}: the composite kernels' bare launches on
    `args` and `cts`, into buffers made once, with the wrapper's launch plan
    (the ray kernels past the tile)."""
    N, S = args[0].shape
    lib, ptr, chk = fused_composite._lib(), fused_composite._ptr, fused_composite._check
    stream = torch.cuda.current_stream().cuda_stream
    outs = [torch.empty_like(o) for o in fused_composite.composite_fwd(*args)]
    grads = [torch.empty_like(t) for t in (args[0], args[1], args[3], args[4])] + [torch.empty((N, 2), device=DEVICE)]
    ins, ct_ptrs = [ptr(t) for t in args], [ptr(t) for t in cts]
    names = lambda arrays: [a for a, _ in arrays]  # noqa: E731
    fplan = fused_composite.launch_plan(N, S, dict(zip(names(fused_composite.FWD_ARRAYS), ins[:5] + [ptr(outs[0])])),
                                        backward=False)
    bplan = fused_composite.launch_plan(N, S, dict(zip(names(fused_composite.BWD_ARRAYS), ins[:5] + ct_ptrs[:1]
                                                       + [ptr(t) for t in grads[:4]])), backward=True)
    print(f"composite launch plans at [{N}, {S}]: forward {fplan}, backward {bplan}")
    launch = fused_composite._launch
    return {
        "fwd_kernel": lambda: chk(lib, launch(lib, False, N, S, fplan, ins, [ptr(t) for t in outs], stream),
                                  "composite_fwd"),
        "bwd_kernel": lambda: chk(lib, launch(lib, True, N, S, bplan, ins + ct_ptrs, [ptr(t) for t in grads], stream),
                                  "composite_bwd"),
    }


def check_superstep(tr, label: str, counts, reset) -> dict:
    """A superstep window of SUPERSTEP steps (`steps_scan`: its first step
    eager under the sync-debug error mode, then the captured step replayed)
    from a cloned state, held against as many eager steps from the same state
    and generator state; then the same window again, replays only. Prints the
    step ms of the three and returns the kernels' launches of the first
    window (the replays counted)."""
    from poseprobe_tpu_torch.core.tree import tree_leaves
    start = ([t.clone() for t in tr.state_tensors()], tr.generator.get_state(), tr.global_step)

    def restore():
        for t, c in zip(tr.state_tensors(), start[0]):
            t.copy_(c)
        tr.generator.set_state(start[1])
        tr.global_step = start[2]
        torch.cuda.synchronize()

    def timed(fn):
        restore()
        t0 = time.perf_counter()
        losses = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / SUPERSTEP * 1e3
        params = {f"{n}[{i}] {tuple(t.shape)}": t.clone() for n in tr.GROUPS
                  for i, t in enumerate(tree_leaves(getattr(tr, f"{n}_params")))}
        counters = [int(tr._step_t)] + [int(getattr(tr, f"opt_{n}_state")["count"]) for n in tr.GROUPS
                                        if getattr(tr, f"opt_{n}_state") is not None]
        return losses.cpu(), params, counters, ms

    tr.drop_graphs()
    eager = timed(lambda: torch.stack([tr.step()["loss_total"] for _ in range(SUPERSTEP)]))
    reset()
    try:
        first = timed(lambda: tr.steps_scan(SUPERSTEP)["loss_total"])
    except RuntimeError as e:
        print(f"{label} superstep: the warm-up under set_sync_debug_mode('error') or the capture failed: {e}")
        raise
    launched = counts()
    replayed = timed(lambda: tr.steps_scan(SUPERSTEP)["loss_total"])
    graph = tr._graphs.graph
    loss_rel, rel_l2, max_abs = 0.0, (0.0, ""), 0.0
    for name, (losses, params, counters, _) in (("first window", first), ("replayed window", replayed)):
        if counters != eager[2]:
            raise AssertionError(f"{label} superstep ({name}): counters {counters}, eager {eager[2]}")
        loss_rel = max(loss_rel, float(((losses - eager[0]).abs() / eager[0].abs()).max()))
        for key, a in params.items():
            b = eager[1][key]
            rel_l2 = max(rel_l2, (float((a - b).norm()) / max(float(b.norm()), 1e-30), key))
            max_abs = max(max_abs, float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30))
    print(f"{label} superstep K={SUPERSTEP} from step {start[2]}: eager {eager[3]:.2f} ms/step; first window "
          f"(eager step, capture {graph.capture_s:.3f} s, {SUPERSTEP - 1} replays) {first[3]:.2f} ms/step; replayed "
          f"window {replayed[3]:.2f} ms/step. Sync-debug warm-up: no synchronisation found. Against the eager "
          f"steps: losses rel {loss_rel:.2e} (tolerance {GRAPH_LOSS_RTOL}); params rel L2 {rel_l2[0]:.2e} "
          f"(tolerance {REL_TOL}, worst {rel_l2[1]}), max abs err / max |param| {max_abs:.2e}; counters equal; "
          f"launches {launched}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not (loss_rel <= GRAPH_LOSS_RTOL and rel_l2[0] <= REL_TOL):
        raise AssertionError(f"{label}: the superstep window disagrees with the eager steps")
    return launched


def drive_early(fused_mlp, grid_ops, layout, pe, tr) -> dict:
    """Early-phase steps (object branch on) of the bench-scale joint trainer.
    Returns the kernels' launch counts of the main-path runs."""
    om, ot, sm = tr.cfg.object_model, tr.cfg.object_train, tr.cfg.scene_model

    def counts():
        return {"trunk_fwd": fused_mlp.fwd_launches, "trunk_bwd": fused_mlp.bwd_launches,
                "trilinear_fwd": grid_ops.fwd_launches, "trilinear_bwd": grid_ops.bwd_launches,
                "transpose2d": layout.transpose2d_launches, "transpose_slice": layout.transpose_slice_launches,
                "materialize": layout.materialize_launches, **pe.launches}

    def reset():
        fused_mlp.fwd_launches = fused_mlp.bwd_launches = 0
        grid_ops.fwd_launches = grid_ops.bwd_launches = 0
        layout.transpose2d_launches = layout.transpose_slice_launches = layout.materialize_launches = 0
        pe.launches.update(dict.fromkeys(pe.launches, 0))

    tr.global_step = 1
    flags = tr.phase_flags(1)
    if not (flags["object_on"] and tr.mask_arr is not None and tr._mask_k):
        raise AssertionError("the bench configuration does not start in the early phase with its mask cache")
    warm, steps = 2, 6
    for _ in range(warm):
        tr.step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t1 = time.perf_counter()
    metrics = [tr.step() for _ in range(steps)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t1) / steps
    early = counts()
    rays = ot.N_rand + sm.rand_rays
    print(f"phase early (step 1, object_on=True, proj_use_deform={flags['proj_use_deform']}, "
          f"{ot.N_rand} object rays x {tr._mask_k} of {om.n_samples} lanes): {dt * 1e3:.2f} ms/step, "
          f"{rays / dt:.1f} object+scene rays/s, loss {float(metrics[0]['loss_total']):.5f} -> "
          f"{float(metrics[-1]['loss_total']):.5f}, psnr_obj {float(metrics[-1]['psnr_obj']):.3f}, "
          f"psnr_scene {float(metrics[-1]['psnr_scene']):.3f}, launches {early}")
    print(f"max memory allocated (early): {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if not all(math.isfinite(float(v)) for m in metrics for v in m.values()):
        raise AssertionError("non-finite metrics in the early phase")
    # per step: the scene half's one coarse trunk render (its encoding by the kernel; the encoding's
    # backward where its points take a gradient, so at most once), the deformed 1-channel value+gradient
    # lookup, the merged 13-channel lookup and the reprojection term's 1-channel lookup, all on the grids'
    # own layout
    if early["posenc_scene_bwd"] > steps:
        raise AssertionError(f"the early phase ran more encoding backwards than trunk backwards: {early}")
    expect = {"trunk_fwd": steps, "trunk_bwd": steps, "trilinear_fwd": 3 * steps, "trilinear_bwd": 3 * steps,
              "transpose2d": 0, "transpose_slice": 0, "materialize": 0, "posenc_scene_fwd": steps,
              "posenc_scene_bwd": early["posenc_scene_bwd"]}
    if early != expect:
        raise AssertionError(f"the early phase's grid lookups did not all run through the kernels: "
                             f"{early}, expected {expect}")
    graph = check_superstep(tr, "early", counts, reset)
    if graph != {k: v // steps * SUPERSTEP for k, v in expect.items()}:
        raise AssertionError(f"the early superstep window did not launch the kernels of {SUPERSTEP} steps: {graph}")

    # one step's loss: kernels, plain versions (the autograd twins), and the barrier switch
    draws = tr.sample_draws(flags)
    step = tr.global_step
    with torch.no_grad():
        fused, _ = tr.joint_loss(tr.obj_params, tr.scene_params, tr.pose_params, step, flags, draws)
        kernels = grid_ops.trilinear_sample, grid_ops.trilinear_sample_with_grad
        grid_ops.trilinear_sample = grid_ops.trilinear_sample_reference
        grid_ops.trilinear_sample_with_grad = grid_ops.trilinear_vg_reference
        try:
            plain, _ = tr.joint_loss(tr.obj_params, tr.scene_params, tr.pose_params, step, flags, draws)
        finally:
            grid_ops.trilinear_sample, grid_ops.trilinear_sample_with_grad = kernels
    rel = abs(float(fused) - float(plain)) / abs(float(plain))
    print(f"early-phase loss with the grid kernels {float(fused):.6f}, with the plain lookups "
          f"{float(plain):.6f} (rel diff {rel:.2e}, tolerance 1e-5)")
    if not rel <= 1e-5:
        raise AssertionError("the early step's loss through the kernels disagrees with the plain lookups'")
    reset()
    os.environ["POSEPROBE_SCATTER_BARRIER"] = "1"
    try:
        m = tr.step(draws)
    finally:
        os.environ.pop("POSEPROBE_SCATTER_BARRIER")
    torch.cuda.synchronize()
    barrier = counts()
    rel = abs(float(m["loss_total"]) - float(fused)) / abs(float(fused))
    print(f"early step with POSEPROBE_SCATTER_BARRIER=1: loss {float(m['loss_total']):.6f} "
          f"(rel diff {rel:.2e}), launches {barrier}")
    if not (rel <= 1e-6 and barrier["materialize"] >= 1 and math.isfinite(float(m["loss_total"]))):
        raise AssertionError("the barrier step did not pass through materialize, or changed the loss")
    return {"early": early, "early_graph": graph, "early_barrier": barrier}


def drive_slice(fused_mlp, pe, trainer_mod) -> dict:
    """Coarse-phase and mid-phase steps of the bench-scale scene trainer.
    Returns the trunk and encoding kernels' launch counts per phase."""
    t0 = time.perf_counter()
    tr = trainer_mod.build_scene_trainer(small=SMALL, device=DEVICE)
    sm = tr.cfg.scene_model
    if not (fused_mlp.supports(sm) and sm.matmul_dtype == "bfloat16"):
        raise AssertionError("the bench configuration does not take the fused trunk")
    print(f"scene trainer built in {time.perf_counter() - t0:.1f} s: {tr.H}x{tr.W}, "
          f"{tr.n_active} active views, {sm.rand_rays} rays, {sm.sample_intvs}+"
          f"{sm.sample_intvs_fine} samples, {tr.scene_matches.shape[1]} matches")
    torch.cuda.reset_peak_memory_stats()
    launches = {}

    def reset():
        fused_mlp.fwd_launches = fused_mlp.bwd_launches = 0
        pe.launches.update(dict.fromkeys(pe.launches, 0))

    def counts():
        return {"trunk_fwd": fused_mlp.fwd_launches, "trunk_bwd": fused_mlp.bwd_launches, **pe.launches}

    for phase, start, warm, steps in (("coarse", trainer_mod.N_ITERS + 1, 2, 8),
                                      ("mid", tr.fine_start + 1, 2, 8)):
        tr.global_step = start
        for _ in range(warm):
            tr.step()
        torch.cuda.synchronize()
        reset()
        t1 = time.perf_counter()
        metrics = [tr.step() for _ in range(steps)]
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t1) / steps
        launches[phase] = counts()
        losses = [float(m["loss_total"]) for m in metrics]
        flags = tr.phase_flags(start)
        print(f"phase {phase} (step {start}, fine_on={flags['fine_on']}, "
              f"depth_cons_on={flags['depth_cons_on']}, pose_on={flags['pose_on']}): {dt * 1e3:.2f} ms/step, "
              f"{sm.rand_rays / dt:.1f} rays/s, loss {losses[0]:.5f} -> {losses[-1]:.5f}, "
              f"psnr {float(metrics[-1]['psnr_scene']):.3f}, launches {launches[phase]}")
        if not all(math.isfinite(x) for m in metrics for x in (float(v) for v in m.values())):
            raise AssertionError(f"non-finite metrics in the {phase} phase")
        c = launches[phase]
        if c["trunk_fwd"] == 0 or c["trunk_bwd"] == 0:
            raise AssertionError(f"the {phase} phase did not run through both trunk kernels")
        # the encoding kernel writes every trunk forward's input; its backward runs where the points take a
        # gradient (the poses' window, the rendered depth of depth consistency), so with at most the trunk's
        if c["posenc_scene_fwd"] != c["trunk_fwd"] or c["posenc_scene_bwd"] > c["trunk_bwd"]:
            raise AssertionError(f"the {phase} phase's encodings did not all run through the kernels: {c}")
        graph = check_superstep(tr, phase, counts, reset)
        if graph != {k: v // steps * SUPERSTEP for k, v in launches[phase].items()}:
            raise AssertionError(f"the {phase} superstep window did not launch the kernels of "
                                 f"{SUPERSTEP} steps: {graph}")
        launches[f"{phase}_graph"] = graph
    print(f"max memory allocated: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    # the same mid-phase step through the kernels and through the plain trunk
    flags = tr.phase_flags(tr.global_step)
    draws = tr.sample_draws(flags)
    with torch.no_grad():
        fused, _ = tr.loss(tr.scene_params, tr.pose_params, tr.global_step, flags, draws)
        tr.cfg = dataclasses.replace(tr.cfg, scene_model=dataclasses.replace(sm, use_fused_trunk=False))
        plain, _ = tr.loss(tr.scene_params, tr.pose_params, tr.global_step, flags, draws)
        tr.cfg = dataclasses.replace(tr.cfg, scene_model=sm)
    rel = abs(float(fused) - float(plain)) / abs(float(plain))
    print(f"mid-phase loss with the kernels {float(fused):.6f}, with the plain trunk "
          f"{float(plain):.6f} (rel diff {rel:.2e}, tolerance {REL_TOL})")
    if not rel <= REL_TOL:
        raise AssertionError("the kernel path's loss disagrees with the plain trunk's")
    return launches


# the two trunk shapes of `drive_trunk_widths`, beside the 8x256 main path: a 128-wide trunk whose
# encoding (99 columns) pads to 128, and a 512-wide one for the wide kernels (csrc/trunk_wide.cu)
WIDTH_CELLS = {"narrow": dict(layers_feat=(128,) * 8, L_3D=16), "wide": dict(layers_feat=(512,) * 8, L_3D=10)}
LONG_RAY_STEPSIZE = 0.08               # 2101 samples at 96^3, a chord-bound K of 1312: past the composite's tile


def drive_trunk_widths(mods: dict, trainer_mod) -> tuple[dict, dict, list]:
    """`build_trainer()` at full size at its mid step (18,001: the fine render
    at 393,216 points and depth consistency) under each trunk of WIDTH_CELLS:
    eager steps with every trunk call counted under the kernel instantiation
    that takes it, the kernels held against their plain versions at the
    step's own calls, the step's loss against the plain trunk, a graph window
    against eager steps, its profile; and each instantiation's forward and
    backward timed at the fine render's call. Returns (launches by phase,
    worst errors by kernel name, the new kernels' records)."""
    fused_mlp, grid_ops = mods["fused_mlp"], mods["grid"]
    by_phase, errs, records = {}, {}, []
    for label, scene in WIDTH_CELLS.items():
        t0 = time.perf_counter()
        cfg, data = trainer_mod._bench_workload(SMALL, "bfloat16")           # build_trainer()'s workload
        tr = trainer_mod.JointTrainer(dataclasses.replace(cfg, scene_model=dataclasses.replace(cfg.scene_model, **scene)),
                                      data, device=DEVICE)
        built_s = time.perf_counter() - t0
        sm = tr.cfg.scene_model
        H, pad = sm.layers_feat[0], fused_mlp.in_pad(sm.input_3d_dim)
        names = {k: fused_mlp.kernel_name(k, H, pad) for k in ("fwd", "bwd")}
        if not (fused_mlp.supports(sm) and sm.matmul_dtype == "bfloat16"):
            raise AssertionError(f"{label}: the trunk {sm.layers_feat} with L_3D={sm.L_3D} does not take the kernels")

        def counts():
            return {names[k]: fused_mlp.launches[names[k]] for k in ("fwd", "bwd")}

        def reset():
            fused_mlp.launches.update(dict.fromkeys(fused_mlp.launches, 0))
            fused_mlp.fwd_launches = fused_mlp.bwd_launches = 0

        tr.global_step = tr.fine_start + 1
        flags = tr.phase_flags(tr.global_step)
        if not (flags["fine_on"] and flags["depth_cons_on"]):
            raise AssertionError(f"{label}: step {tr.global_step} is not the mid phase: {flags}")
        torch.cuda.reset_peak_memory_stats()
        start = tr.global_step
        ms, eager, metrics = _eager_steps(tr, 1, counts, reset)
        every = {names["fwd"]: fused_mlp.fwd_launches, names["bwd"]: fused_mlp.bwd_launches}
        print(f"{label} trunk {sm.layers_feat[0]}x{len(sm.layers_feat)}, L_3D={sm.L_3D} (input {sm.input_3d_dim}, "
              f"pad {pad}), mid step {start} of build_trainer() (built in {built_s:.1f} s): "
              f"eager {ms:.2f} ms/step, loss {float(metrics[0]['loss_total']):.5f}; launches {eager} of all trunk "
              f"calls {every}")
        # per step: the main render coarse + fine, the reference and unseen-pose renders of depth
        # consistency; backwards for the four the loss reads (as the 8x256 mid step)
        if not (eager == every == {names["fwd"]: 6, names["bwd"]: 4}):
            raise AssertionError(f"{label}: the mid step's trunk calls did not all run through {names}: {eager}, "
                                 f"all calls {every}")
        calls = []
        with _capturing(fused_mlp, grid_ops, calls, []):
            tr.step()
        torch.cuda.synchronize()
        worst = _hold_captured(fused_mlp, grid_ops, [], calls, label, lookup_bwd=False)
        for k in ("fwd", "bwd"):
            errs[names[k]] = max(errs.get(names[k], 0.0), worst[f"trunk_{k}"])
        _, rel = _loss_against_plain(tr, lambda f, d: tr.joint_loss(tr.obj_params, tr.scene_params, tr.pose_params,
                                                                      tr.global_step, f, d)[0], grid_ops)
        print(f"{label} mid step loss through the kernels against the plain trunk: rel diff {rel:.2e} "
              f"(tolerance {REL_TOL})")
        if not rel <= REL_TOL:
            raise AssertionError(f"{label}: the mid step's loss through the kernels disagrees with the plain trunk's")
        graph = check_superstep(tr, label, counts, reset)
        if graph != {k: v * SUPERSTEP for k, v in eager.items()}:
            raise AssertionError(f"{label}: the graph window did not launch the trunk kernels of {SUPERSTEP} steps: "
                                 f"{graph}")
        by_phase[label], by_phase[f"{label}_graph"] = eager, graph
        _profile(tr, label)
        # the kernels timed at the fine render's call (the step's largest)
        enc, w, b, L, skip = max(calls, key=lambda c: c[0].shape[0])
        n = enc.shape[0]
        feat, _, acts = fused_mlp.trunk_fwd_plain(enc, w, b, L, skip)
        g = torch.Generator(device=DEVICE).manual_seed(n)
        g_feat = (torch.randn(feat.shape, generator=g, device=DEVICE) * 1e-3).to(torch.bfloat16)
        g_dens = (torch.randn(n, generator=g, device=DEVICE) * 1e-3).to(torch.bfloat16)
        recs = _trunk_records(fused_mlp, sm, enc, w, b, L, skip, g_feat, g_dens, feat, acts, errs[names["fwd"]],
                              errs[names["bwd"]])
        recs["bwd"].update(_trunk_bwd_parts(fused_mlp, enc, g_feat, g_dens, feat, acts, w, b, L, skip))
        records += [recs["fwd"], recs["bwd"]]
        del tr, calls, feat, acts
        torch.cuda.empty_cache()
    return by_phase, errs, records


def drive_long_rays(mods: dict, trainer_mod) -> dict:
    """One early step of `build_trainer()` with the fused composite on and
    the object step size at LONG_RAY_STEPSIZE, so that the chord-bound K
    passes the composite's tile: the step runs through the ray kernels
    (one launch each way), and its loss equals the same step through the
    unfused composite on the same draws (1e-5 relative)."""
    fc = mods["fused_composite"]
    cfg, data = trainer_mod._bench_workload(SMALL, "bfloat16")               # build_trainer()'s workload
    om = dataclasses.replace(cfg.object_model, use_pallas_composite=True, stepsize=LONG_RAY_STEPSIZE)
    tr = trainer_mod.JointTrainer(dataclasses.replace(cfg, object_model=om), data, device=DEVICE)
    if not tr._mask_k > COMPOSITE_TILE or (not SMALL and tr._mask_k != LONG_RAY_K):
        raise AssertionError(f"the long-ray step's K {tr._mask_k}: expected {LONG_RAY_K}, past the tile {COMPOSITE_TILE}")
    tr.global_step = 1
    tr.step()                                          # warm
    flags = tr.phase_flags(tr.global_step)
    draws = tr.sample_draws(flags)
    with torch.no_grad():
        cfg = tr.cfg
        tr.cfg = dataclasses.replace(cfg, object_model=dataclasses.replace(om, use_pallas_composite=False))
        plain = float(tr.joint_loss(tr.obj_params, tr.scene_params, tr.pose_params, tr.global_step, flags, draws)[0])
        tr.cfg = cfg
    before = (fc.fwd_chunked_launches, fc.bwd_chunked_launches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = tr.step(draws)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launched = {"composite_fwd_chunked": fc.fwd_chunked_launches - before[0],
                "composite_bwd_chunked": fc.bwd_chunked_launches - before[1]}
    rel = abs(float(m["loss_total"]) - plain) / abs(plain)
    print(f"long-ray early step (stepsize {om.stepsize}: {om.n_samples} samples, chord-bound K {tr._mask_k}, "
          f"{tr.cfg.object_train.N_rand} object rays): eager step {ms:.2f} ms, loss {float(m['loss_total']):.6f}, unfused "
          f"{plain:.6f} (rel diff {rel:.2e}, tolerance 1e-5), launches {launched}")
    if not (rel <= 1e-5 and launched == {"composite_fwd_chunked": 1, "composite_bwd_chunked": 1}
            and all(math.isfinite(float(v)) for v in m.values())):
        raise AssertionError("the long-ray step did not run through the composite's ray kernels, or disagrees")
    return {"long_rays": launched}


# the trunk instantiations held at every checkpoint stride (label, width, L_3D): the five of
# `fused_mlp.KERNEL_NAMES` (L_3D 10 pads the encoding to 64, 16 to 128; 8x384 is the wide family's
# first width) and the wide cell's 8x512
CKPT_CELLS = (("8x256", 256, 10), ("8x256 pad 128", 256, 16), ("8x128 pad 64", 128, 10), ("8x128", 128, 16),
              ("8x384", 384, 10), ("8x512", 512, 10))
CKPT_STRIDES = (0, 2)                   # held against stride 1 (the default)
CKPT_RECORDS = ("8x256", "8x128", "8x512")   # the cells a mid step below runs: their remat records
CKPT_STEP_CELLS = (("8x256", {}, (0, 2)), ("8x128", WIDTH_CELLS["narrow"], (0,)),
                   ("8x512", WIDTH_CELLS["wide"], (0,)))


def _layer_macs(cfg) -> list:
    """Multiply-adds per point of each trunk layer (unpadded), as `_trunk_macs`."""
    D, H, L = cfg.input_3d_dim, cfg.layers_feat[0], len(cfg.layers_feat)
    return [((D if l == 0 else H) + (D if l == cfg.skip[0] else 0)) * (H + 1 if l == L - 1 else H) for l in range(L)]


def _ckpt_bounds(fused_mlp, cfg, n: int, pad: int, w, b, ckpt: int) -> dict:
    """The bounds at stride `ckpt` for n points: the remat alone (the layers
    it computes, and the stored layers read once, every hidden layer written
    once, the encoding and weights read once) and the whole backward (the
    backward's products, twice the multiply-adds, plus the remat's, and the
    backward's inputs and outputs with the stored layers in place of all)."""
    H, L = cfg.layers_feat[0], len(cfg.layers_feat)
    macs = _layer_macs(cfg)
    stored = fused_mlp.stored_layers(L, ckpt)
    remat_macs = sum(macs[l] for l in range(L - 1) if l not in stored)
    layer = n * H * 2
    wb = (w.numel() + b.numel()) * 2
    remat = _bound(2 * remat_macs * n, n * pad * 2 + wb + (len(stored) + L - 1) * layer)
    bwd_bytes = (n * pad * 2 + n * H * 2 + n * 2 + n * H * 2 + len(stored) * layer + w.numel() * 2 + n * pad * 2
                 + (w.numel() + b.numel()) * 4)
    bwd = _bound(4 * sum(macs) * n + (2 * remat_macs * n if ckpt != 1 else 0), bwd_bytes)
    return {"remat_bound_ms": remat[0], "remat_bound_by": remat[1], "bwd_bound_ms": bwd[0], "bwd_bound_by": bwd[1]}


def check_ckpt_kernels(fused_mlp, scene_nerf, pe) -> tuple[dict, dict]:
    """Each CKPT_CELLS trunk at FINE_POINTS and RAGGED_POINTS, at strides 0
    and 2 against stride 1: the forward's feat and density and its stored
    layers bit for bit; the remat kernel's buffer equal to stride 1's stored
    layers bit for bit and within REL_TOL of its plain version; the
    backward's denc bit for bit, db bit for bit at width 128 and dW from
    width 384 (summed in a fixed order), the rest within 1e-4 relative + 1e-4
    of the largest (f32 atomics), and the backward within REL_TOL of its
    plain version on the layers the remat refilled (the plain remat, held
    apart, may round a value to the other side of a ReLU and so reroute one
    point's gradient). At FINE_POINTS each stride's forward,
    backward, remat, chain and dW are timed in turns (1, 0, 2, 2, 0, 1).
    Returns ({label: times, bounds and errors}, {remat name: kernel record})
    for the cells of CKPT_RECORDS."""
    results, records = {}, {}
    for label, width, l3d in CKPT_CELLS:
        cfg = scene_nerf.SceneConfig(layers_feat=(width,) * 8, L_3D=l3d)
        L, skip = len(cfg.layers_feat), cfg.skip[0]
        mlp = scene_nerf.init_nerf_mlp(torch.Generator().manual_seed(0), cfg)
        w, b = fused_mlp.pack_params([{k: v.to(DEVICE) for k, v in la.items()} for la in mlp["feat"]], skip)
        exact = {"denc": True, "dw": width not in fused_mlp.WGMMA_WIDTHS, "db": width == fused_mlp.NARROW_WIDTH}
        worst = {"remat": 0.0, "bwd": 0.0}
        for n in (FINE_POINTS, RAGGED_POINTS):
            g = torch.Generator(device=DEVICE).manual_seed(n)
            points = torch.rand((n, 3), generator=g, device=DEVICE) * 6.0 - 3.0
            enc = pe.posenc_scene(points, cfg.L_3D, 1.0, cfg.barf_c2f).to(torch.bfloat16)
            pad = fused_mlp.in_pad(enc.shape[1])
            enc = torch.nn.functional.pad(enc, (0, pad - enc.shape[1])).contiguous()
            feat, dens, full = fused_mlp.trunk_fwd(enc, w, b, L, skip)
            g_feat = (torch.randn((n, width), generator=g, device=DEVICE) * 1e-3).to(torch.bfloat16)
            g_dens = (torch.randn(n, generator=g, device=DEVICE) * 1e-3).to(torch.bfloat16)
            want = fused_mlp.trunk_bwd(enc, g_feat, g_dens, feat, full, w, b, L, skip)
            stored_acts = {1: full}
            for ckpt in CKPT_STRIDES:
                stored = fused_mlp.stored_layers(L, ckpt)
                f, d, acts = fused_mlp.trunk_fwd(enc, w, b, L, skip, store_acts=stored)
                remat = fused_mlp.trunk_remat(enc, acts, w, b, L, skip, ckpt)
                got = fused_mlp.trunk_bwd(enc, g_feat, g_dens, f, acts, w, b, L, skip, ckpt)
                remat_ref = fused_mlp.trunk_remat_plain(enc, acts, w, b, L, skip, ckpt)
                bwd_ref = fused_mlp.trunk_bwd_plain(enc, g_feat, g_dens, f, remat, w, b, L, skip)
                torch.cuda.synchronize()
                what = f"{label} N={n} stride {ckpt}"
                if not (torch.equal(f, feat) and torch.equal(d, dens)
                        and (acts is None if not stored else torch.equal(acts, full[list(stored)]))):
                    raise AssertionError(f"{what}: the forward's outputs or stored layers differ from stride 1's")
                if not torch.equal(remat, full):
                    raise AssertionError(f"{what}: the remat kernel's layers differ from the forward's")
                for key, o, r in zip(("denc", "dw", "db"), got, want):
                    if exact[key]:
                        if not torch.equal(o, r):
                            raise AssertionError(f"{what}: {key} differs from stride 1's")
                    else:
                        torch.testing.assert_close(o, r, rtol=1e-4, atol=1e-4 * float(r.abs().max()),
                                                   msg=lambda m: f"{what}: {key} against stride 1's: {m}")
                r_abs, r_rel = _max_err([remat], [remat_ref])
                b_abs, b_rel = _max_err(got, bwd_ref)
                print(f"trunk {what}: feat, density, stored layers and remat bit-identical to stride 1, denc "
                      f"bit-identical, dW {'bit-identical' if exact['dw'] else 'within 1e-4'}, db "
                      f"{'bit-identical' if exact['db'] else 'within 1e-4'}; the remat against its plain version max "
                      f"abs err {r_abs:.3e} ({r_rel:.3e} of max), the backward against its plain version on the "
                      f"refilled layers {b_abs:.3e} ({b_rel:.3e} of max), tolerance {REL_TOL} of max")
                if not (r_rel <= REL_TOL and b_rel <= REL_TOL):
                    raise AssertionError(f"{what}: the remat or the backward disagrees with its plain version")
                worst["remat"], worst["bwd"] = max(worst["remat"], r_abs), max(worst["bwd"], b_abs)
                stored_acts[ckpt] = acts
                del remat_ref, bwd_ref
            if n != FINE_POINTS:
                continue
            # in turns: each stride's forward, backward and remat; chain and dW on the full layers
            out = fused_mlp._bwd_outputs(n, w, b, L, pad)
            buf = torch.empty_like(full)
            times = {}
            for ckpt in (1, 0, 2, 2, 0, 1):
                stored, acts = fused_mlp.stored_layers(L, ckpt), stored_acts[ckpt]
                t = times.setdefault(ckpt, {"fwd_ms": [], "bwd_ms": [], "remat_ms": [], "chain_ms": [], "dw_ms": []})
                t["fwd_ms"].append(_time_ms(lambda: fused_mlp.trunk_fwd(enc, w, b, L, skip, store_acts=stored)))
                t["bwd_ms"].append(_time_ms(lambda: fused_mlp.trunk_bwd(enc, g_feat, g_dens, feat, acts, w, b, L,
                                                                        skip, ckpt)))
                if ckpt != 1:
                    t["remat_ms"].append(_time_ms(lambda: fused_mlp.trunk_remat(enc, acts, w, b, L, skip, ckpt,
                                                                                out=buf)))
                for part in ("chain", "dw"):
                    t[f"{part}_ms"].append(_time_ms(lambda: fused_mlp._bwd_launch(enc, g_feat, g_dens, feat, full, w,
                                                                                  out, L, skip, (part,))))
            plain_ms = _time_ms(lambda: fused_mlp.trunk_remat_plain(enc, None, w, b, L, skip, 0), iters=3, warmup=1)
            cell = {"name": fused_mlp.kernel_name("remat", width, pad), "pad": pad, "points": n,
                    "remat_plain_ms": plain_ms, "max_abs_err": worst}
            for ckpt, t in times.items():
                cell[f"ckpt{ckpt}"] = ({k: sum(v) / len(v) for k, v in t.items() if v}
                                       | {"turns": {k: v for k, v in t.items() if v}}
                                       | _ckpt_bounds(fused_mlp, cfg, n, pad, w, b, ckpt)
                                       | {"stored_gb": len(fused_mlp.stored_layers(L, ckpt)) * n * width * 2 / 1e9})
                c = cell[f"ckpt{ckpt}"]
                print(f"trunk {label} N={n} stride {ckpt}: forward {c['fwd_ms']:.4f} ms, backward {c['bwd_ms']:.4f} ms "
                      f"(bound {c['bwd_bound_ms']:.4f} ms, {c['bwd_bound_by']}), remat "
                      + (f"{c['remat_ms']:.4f} ms (bound {c['remat_bound_ms']:.4f} ms, {c['remat_bound_by']})"
                         if ckpt != 1 else "none")
                      + f", chain {c['chain_ms']:.4f} ms, dW {c['dw_ms']:.4f} ms; stored layers {c['stored_gb']:.3f} GB")
            results[label] = cell
            del out, buf
        cell = results[label]
        if label in CKPT_RECORDS:
            rec = {"name": cell["name"], "route": "cuda",
                   "source": "poseprobe_tpu_torch/csrc/" + ("fused_trunk.cu" if width in fused_mlp.WGMMA_WIDTHS
                                                           else "trunk_wide.cu"),
                   "replaces": "poseprobe_tpu/ops/pallas/fused_mlp.py:284", "launches": 0,
                   "max_abs_err": worst["remat"], "ms": cell["ckpt0"]["remat_ms"], "plain_ms": cell["remat_plain_ms"],
                   "bound_ms": cell["ckpt0"]["remat_bound_ms"], "bound_by": cell["ckpt0"]["remat_bound_by"],
                   "library_ms": None, "ms_ckpt2": cell["ckpt2"]["remat_ms"],
                   "bound_ms_ckpt2": cell["ckpt2"]["remat_bound_ms"],
                   "bwd_ms_by_ckpt": {k: cell[f"ckpt{k}"]["bwd_ms"] for k in (1, 0, 2)},
                   "fwd_ms_by_ckpt": {k: cell[f"ckpt{k}"]["fwd_ms"] for k in (1, 0, 2)}}
            records[label] = rec
            print(f"{rec['name']}: kernel {rec['ms']:.4f} ms at stride 0 ({rec['ms_ckpt2']:.4f} at 2), plain "
                  f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), max abs err "
                  f"{rec['max_abs_err']:.3e}")
        del full, feat, stored_acts
        torch.cuda.empty_cache()
    print("trunk strides: " + json.dumps(results))
    return results, records


def _mid_step_strides(fused_mlp, tr, label: str, strides: tuple) -> dict:
    """`tr` at its mid step (18,001): one eager step at stride 1 and at each
    of `strides` from one state (the draws, the state and the step restored
    before each), the loss equal to stride 1's and the parameters after the
    step within REL_TOL (rel L2) of stride 1's, each step's launches by
    kernel (6 forwards, 4 backwards and, past stride 1, 4 remats) and its
    peak memory; then a graph window at stride 1 and at each of `strides`
    against eager steps (`check_superstep`: their step times and peak
    memory). Returns the launches by phase."""
    sm = tr.cfg.scene_model
    H, pad = sm.layers_feat[0], fused_mlp.in_pad(sm.input_3d_dim)
    names = {k: fused_mlp.kernel_name(k, H, pad) for k in ("fwd", "bwd", "remat")}

    def counts():
        return {names[k]: fused_mlp.launches[names[k]] for k in names}

    def reset():
        fused_mlp.launches.update(dict.fromkeys(fused_mlp.launches, 0))
        fused_mlp.fwd_launches = fused_mlp.bwd_launches = 0

    from poseprobe_tpu_torch.core.tree import tree_leaves
    tr.global_step = tr.fine_start + 1
    flags = tr.phase_flags(tr.global_step)
    if not (flags["fine_on"] and flags["depth_cons_on"]):
        raise AssertionError(f"{label}: step {tr.global_step} is not the mid phase: {flags}")
    for _ in range(2):
        tr.step()
    torch.cuda.synchronize()
    start = ([t.clone() for t in tr.state_tensors()], tr.generator.get_state(), tr.global_step)
    host = _host_state(tr)
    by_phase, steps = {}, {}
    for ckpt in (1,) + strides:
        fused_mlp.TRUNK_CKPT = ckpt
        tr.generator.set_state(start[1])
        tr.global_step = start[2]
        _copy_state(tr, start[0], host, f"{label} stride {ckpt}")
        reset()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = tr.step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        steps[ckpt] = {"loss": float(m["loss_total"]), "ms": ms, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                       "launches": counts(),
                       "params": [t.clone() for n in tr.GROUPS for t in tree_leaves(getattr(tr, f"{n}_params"))]}
        expect = {names["fwd"]: 6, names["bwd"]: 4, names["remat"]: 0 if ckpt == 1 else 4}
        if steps[ckpt]["launches"] != expect or not math.isfinite(steps[ckpt]["loss"]):
            raise AssertionError(f"{label} stride {ckpt}: launches {steps[ckpt]['launches']}, expected {expect}, "
                                 f"loss {steps[ckpt]['loss']}")
        by_phase[f"{label}_ckpt{ckpt}"] = steps[ckpt]["launches"]
    for ckpt in strides:
        a, b = steps[ckpt], steps[1]
        loss_rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
        rel_l2 = max(float((x - y).norm()) / max(float(y.norm()), 1e-30) for x, y in zip(a["params"], b["params"]))
        print(f"{label} mid step {start[2]} at stride {ckpt}: loss {a['loss']:.6f} (stride 1 {b['loss']:.6f}, rel diff "
              f"{loss_rel:.2e}, tolerance 1e-6), params after the step rel L2 {rel_l2:.2e} from stride 1's (tolerance "
              f"{REL_TOL}); eager step {a['ms']:.2f} ms (stride 1 {b['ms']:.2f}); peak memory {a['peak_gib']:.3f} GiB "
              f"(stride 1 {b['peak_gib']:.3f} GiB); launches {a['launches']}")
        if not (loss_rel <= 1e-6 and rel_l2 <= REL_TOL):
            raise AssertionError(f"{label}: the mid step at stride {ckpt} disagrees with stride 1's")
    for ckpt in (1,) + strides:
        fused_mlp.TRUNK_CKPT = ckpt
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        graph = check_superstep(tr, f"{label} stride {ckpt}", counts, reset)
        expect = {k: v * SUPERSTEP for k, v in by_phase[f"{label}_ckpt{ckpt}"].items()}
        if graph != expect:
            raise AssertionError(f"{label} stride {ckpt}: the graph window launched {graph}, expected {expect}")
        by_phase[f"{label}_ckpt{ckpt}_graph"] = graph
    print(f"{label} mid step peak memory by stride (GiB): "
          + json.dumps({k: round(v["peak_gib"], 4) for k, v in steps.items()}))
    return by_phase


def drive_trunk_ckpt(mods: dict, scene_nerf, pe, trainer_mod) -> tuple[dict, list]:
    """The trunk's activation-checkpoint strides (`fused_mlp.TRUNK_CKPT`,
    $POSEPROBE_TRUNK_CKPT): `check_ckpt_kernels` at every instantiation, then
    `build_trainer()`'s mid step under each trunk of CKPT_STEP_CELLS (8x256;
    the narrow and wide cells of `drive_trunk_widths`) at its strides
    (`_mid_step_strides`). The stride is set back to what it was. Returns
    (launches by phase, the remat kernels' records)."""
    fused_mlp = mods["fused_mlp"]
    saved = fused_mlp.TRUNK_CKPT
    try:
        _, records = check_ckpt_kernels(fused_mlp, scene_nerf, pe)
        by_phase = {}
        for label, scene, strides in CKPT_STEP_CELLS:
            cfg, data = trainer_mod._bench_workload(SMALL, "bfloat16")           # build_trainer()'s workload
            tr = trainer_mod.JointTrainer(
                dataclasses.replace(cfg, scene_model=dataclasses.replace(cfg.scene_model, **scene)), data,
                device=DEVICE)
            by_phase.update(_mid_step_strides(fused_mlp, tr, label, strides))
            del tr
            torch.cuda.empty_cache()
    finally:
        fused_mlp.TRUNK_CKPT = saved
    return by_phase, [records[k] for k in CKPT_RECORDS]


def drive_fit(mods: dict, trainer_mod) -> dict:
    """`JointTrainer.fit()` at bench scale across the activation of view 2,
    with PnP seeding, the fused composite, a mask-cache refresh and a BA event
    inside the run. Returns the kernels' launch counts of the `fit` call."""
    from poseprobe_tpu_torch.config import config as cfg_mod
    from poseprobe_tpu_torch.eval import evaluator
    from poseprobe_tpu_torch.pose_init import pnp as pnp_mod
    fused_mlp, grid_ops, layout, fused_composite = (mods[k] for k in ("fused_mlp", "grid", "layout",
                                                                       "fused_composite"))

    def counts():
        return {"trunk_fwd": fused_mlp.fwd_launches, "trunk_bwd": fused_mlp.bwd_launches,
                "trilinear_fwd": grid_ops.fwd_launches, "trilinear_bwd": grid_ops.bwd_launches,
                "transpose2d": layout.transpose2d_launches, "transpose_slice": layout.transpose_slice_launches,
                "composite_fwd": fused_composite.fwd_launches, "composite_bwd": fused_composite.bwd_launches}

    def reset():
        fused_mlp.fwd_launches = fused_mlp.bwd_launches = 0
        grid_ops.fwd_launches = grid_ops.bwd_launches = 0
        layout.transpose2d_launches = layout.transpose_slice_launches = layout.materialize_launches = 0
        fused_composite.fwd_launches = fused_composite.bwd_launches = 0

    activate_at, refresh_at, ba_at, n_steps = 12, 14, 16, 20
    cfg, data = trainer_mod._bench_workload(SMALL, "bfloat16")
    cfg = dataclasses.replace(
        cfg,
        camera=dataclasses.replace(cfg.camera, incremental_step=activate_at, activation_pose_warmup=20,
                                   activation_warmup_photo_ratio=1.5,
                                   ba_at_ratios=((ba_at + 0.5) / trainer_mod.MAX_ITER,)),
        pnp=cfg_mod.PnPConfig(use_pnp=True),
        object_model=dataclasses.replace(cfg.object_model, use_pallas_composite=True),
        object_train=dataclasses.replace(cfg.object_train, maskcache_update_every=refresh_at))
    print(f"fit: PnP path {pnp_mod.pnp_path()} (OpenCV {'found' if pnp_mod.pnp_path() == 'cv2' else 'not found'}: "
          f"{'cv2.solvePnPRansac' if pnp_mod.pnp_path() == 'cv2' else 'numpy DLT RANSAC; BA polish and match refinement decline'})")
    t0 = time.perf_counter()
    tr = trainer_mod.JointTrainer(cfg, data, device=DEVICE)
    torch.cuda.synchronize()
    seed_err = float((tr.poses_pnp - tr.poses_gt).abs().max())
    print(f"fit: joint trainer with the PnP chain built in {time.perf_counter() - t0:.2f} s; seeded poses within "
          f"{seed_err:.4f} of GT (max abs entry), chord-bound K {tr._mask_k}")
    if not (tr.n_active == 2 and tr.fix_first_pose and tr._ba_steps() == (ba_at,)
            and math.isfinite(seed_err) and seed_err < 0.5):
        raise AssertionError("the fit configuration did not seed two active views by PnP")

    # time the parts of the activation event (PnP, warmup, fixed-ray scores) and the other
    # host events around their entry points
    spent = {k: 0.0 for k in ("pnp", "warmup", "score", "activation", "ba", "refresh")}
    calls = {k: 0 for k in spent}

    def timed(key, fn):
        def call(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t
            calls[key] += 1
            return out
        return call

    originals = (pnp_mod.pnp_from_matches, evaluator.test_time_pose_optim, evaluator.photometric_pose_score)
    pnp_mod.pnp_from_matches = timed("pnp", originals[0])
    evaluator.test_time_pose_optim = timed("warmup", originals[1])
    evaluator.photometric_pose_score = timed("score", originals[2])
    tr.maybe_activate_view = timed("activation", tr.maybe_activate_view)      # counts every step's call
    tr.polish_poses_ba = timed("ba", tr.polish_poses_ba)
    tr.refresh_maskcache = timed("refresh", tr.refresh_maskcache)
    windows = []
    scan = tr.steps_scan

    def window(k):
        windows.append((tr.global_step, k))
        return scan(k)
    tr.steps_scan = window
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    try:
        hist = [dict(h) for h in tr.fit(n_steps, log_every=SUPERSTEP, superstep=SUPERSTEP)]
    finally:
        pnp_mod.pnp_from_matches, evaluator.test_time_pose_optim, evaluator.photometric_pose_score = originals
        del tr.steps_scan
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    fit_counts = counts()
    events = spent["activation"] + spent["ba"] + spent["refresh"]
    print(f"fit: {n_steps} early steps across the activation of view 2 in {dt:.2f} s, {events:.3f} s of it in host "
          f"events ({(dt - events) / n_steps * 1e3:.2f} ms/step in superstep windows and single steps, metrics read "
          f"back every {SUPERSTEP} steps); activation "
          f"event {spent['activation']:.3f} s: PnP {spent['pnp']:.3f} s ({calls['pnp']} solve), warmup "
          f"{spent['warmup']:.3f} s ({calls['warmup']} x {cfg.camera.activation_pose_warmup} Adam iterations on 1024 "
          f"rays), fixed-ray scores {spent['score']:.3f} s ({calls['score']} x 2048 rays), the rest match geometry "
          f"and the chord-K re-bound; BA polish {spent['ba']:.3f} s; mask-cache refresh {spent['refresh']:.3f} s")
    print(f"fit: launches {fit_counts}; superstep windows (first step, steps) {windows}")
    print(f"fit: loss {hist[0]['loss_total']:.5f} -> {hist[-1]['loss_total']:.5f}, psnr_obj "
          f"{hist[-1]['psnr_obj']:.3f}, psnr_scene {hist[-1]['psnr_scene']:.3f}, active views at the logged "
          f"steps {[(h['step'], h['n_active']) for h in hist]}")
    # windows end at the log steps and stop short of the activation (12), the refresh (14) and BA (16)
    if windows != [(0, SUPERSTEP), (4, SUPERSTEP), (8, SUPERSTEP), (16, SUPERSTEP)]:
        raise AssertionError(f"fit did not run its steps between the events as superstep windows: {windows}")
    if ([(h["step"], h["n_active"]) for h in hist] != [(4, 2), (8, 2), (12, 2), (16, 3), (20, 3)]
            or tr.n_active != 3):
        raise AssertionError("view 2 was not activated at its step")
    if not all(math.isfinite(v) for h in hist for v in h.values()):
        raise AssertionError("non-finite metrics in fit")
    if not (calls["pnp"] == 1 and calls["warmup"] >= 1 and calls["score"] >= 2 and calls["ba"] == 1
            and calls["refresh"] == 1):
        raise AssertionError(f"fit did not run PnP, the warmup, the scores, one BA event and one refresh: {calls}")
    # every early step renders the object rays once: one composite forward and one backward
    if not (fit_counts["composite_fwd"] == fit_counts["composite_bwd"] == n_steps):
        raise AssertionError(f"the composite kernels did not carry every early step: {fit_counts}")
    if min(v for k, v in fit_counts.items() if k not in OFF_PATH) < n_steps:
        raise AssertionError(f"a kernel of the early step was launched less than once a step: {fit_counts}")
    if not torch.equal(tr.mask_arr, torch.ones_like(tr.mask_arr)) or tr._mask_k != tr._k_phase:
        raise AssertionError("the mask-cache refresh left the plastic phase's all-true mask and chord K")
    health = tr.check_probe_health()
    t0 = time.perf_counter()
    psnr = tr.validate(1)
    torch.cuda.synchronize()
    print(f"fit: probe health {health}; validation PSNR {psnr:.3f} over 1 test view in "
          f"{time.perf_counter() - t0:.2f} s")
    if not (health["healthy"] and math.isfinite(psnr) and psnr > 0):
        raise AssertionError("probe health or validation failed after fit")

    # one early step's loss (three views active): composite kernels against the plain version
    fused_cfg = tr.cfg
    plain_cfg = dataclasses.replace(fused_cfg, object_model=dataclasses.replace(
        fused_cfg.object_model, use_pallas_composite=False))
    flags = tr.phase_flags(tr.global_step)
    draws = tr.sample_draws(flags)
    with torch.no_grad():
        fused, _ = tr.joint_loss(tr.obj_params, tr.scene_params, tr.pose_params, tr.global_step, flags, draws)
        tr.cfg = plain_cfg
        plain, _ = tr.joint_loss(tr.obj_params, tr.scene_params, tr.pose_params, tr.global_step, flags, draws)
        tr.cfg = fused_cfg
    rel = abs(float(fused) - float(plain)) / abs(float(plain))
    print(f"early-phase loss with the composite kernels {float(fused):.6f}, with the plain composite "
          f"{float(plain):.6f} (rel diff {rel:.2e}, tolerance 1e-5)")
    if not rel <= 1e-5:
        raise AssertionError("the early step's loss through the composite kernels disagrees with the plain version's")

    # step time with the fused composite on and off, in turns, inside this one run
    ms = {"fused": [], "plain": []}
    for name in ("fused", "plain", "plain", "fused"):
        tr.cfg = fused_cfg if name == "fused" else plain_cfg
        tr.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(6):
            tr.step()
        torch.cuda.synchronize()
        ms[name].append((time.perf_counter() - t0) / 6 * 1e3)
    tr.cfg = fused_cfg
    print(f"early step, 3 views active, ms/step in turns (fused, plain, plain, fused): fused composite "
          f"{ms['fused'][0]:.2f} and {ms['fused'][1]:.2f}, plain composite {ms['plain'][0]:.2f} and {ms['plain'][1]:.2f}")

    # the lookups of a later early step (three views active, the mask cache refreshed), timed as the
    # first step's are in `check_trilinear_kernels`
    late = capture_lookup_points(grid_ops, tr, "late")
    time_lookups(grid_ops, [(f"late lookup {i}", gs, wg, p, l, h) for i, (gs, wg, p, l, h) in enumerate(late)])
    return {"fit": fit_counts}


def _dtu_fixture(synthetic, H: int, W: int):
    """The synthetic scene (noise texture) as a DTU scan of PRESET_VIEWS views:
    its test view is DTU view 0 and its three train views are views 1-3, so
    `selected_id=(1, 2, 3)` trains on them and view 0 survives DTU's exclude
    list (views 3-7) as the test view."""
    scene = synthetic.make_synthetic_scene(n_train=3, n_test=PRESET_VIEWS - 3, H=H, W=W, seed=0, texture="noise",
                                           n_matches=256)
    order = [3, 0, 1, 2]
    return scene, dataclasses.replace(scene, images=scene.images[order], masks=scene.masks[order],
                                      Ks=scene.Ks[order], poses_gt_w2c=scene.poses_gt_w2c[order],
                                      depth_gt=scene.depth_gt[order])


def check_path_kernels(fused_mlp, grid_ops, tr, label: str) -> dict:
    """The trilinear and trunk kernels against their plain versions at the
    shapes of one step of `tr` (run here, eager): every grid lookup's own
    points (`capture_lookup_points`) on a random grid of its shape, the
    forward (value, and gradient where the step takes it) and the backward
    to grid and points under random cotangents; every trunk call's own
    inputs, and its backward under random cotangents. Tolerances as in
    `check_trilinear_kernels` and `check_trunk_kernels`. Returns the worst
    max abs error by kernel."""
    calls, trunk_fwd = [], fused_mlp.trunk_fwd

    def watch(enc, w, b, L, skip, store_acts=True):
        calls.append((enc.detach().clone(), w.detach().clone(), b.detach().clone(), L, skip))
        return trunk_fwd(enc, w, b, L, skip, store_acts)

    fused_mlp.trunk_fwd = watch
    try:
        lookups = capture_lookup_points(grid_ops, tr, label)
    finally:
        fused_mlp.trunk_fwd = trunk_fwd
    if not (lookups and calls):
        raise AssertionError(f"{label}: the step made {len(lookups)} lookups and {len(calls)} trunk calls")
    return _hold_captured(fused_mlp, grid_ops, lookups, calls, label, lookup_bwd=True)


def _hold_captured(fused_mlp, grid_ops, lookups: list, calls: list, label: str, lookup_bwd: bool) -> dict:
    """Each captured lookup [(grid shape, with_grad, points, lo, hi)] on a
    random grid of its shape, and each captured trunk call [(enc, w, b, L,
    skip)] on its own inputs, through the kernels and their plain versions:
    the forwards, and the backwards under random cotangents (the lookups'
    only with `lookup_bwd`). Returns the worst max abs error by kernel."""
    held = ("trilinear_fwd", "trilinear_bwd") if lookup_bwd else ("trilinear_fwd",)
    worst = dict.fromkeys(held + ("trunk_fwd", "trunk_bwd"), 0.0)
    for i, (gs, wg, pts, lo, hi) in enumerate(lookups):
        g = torch.Generator(device=DEVICE).manual_seed(100 + i)
        grid = torch.randn(gs, generator=g, device=DEVICE)
        ct_v = torch.randn((pts.shape[0], gs[0]), generator=g, device=DEVICE)
        ct_g = torch.randn((pts.shape[0], gs[0], 3), generator=g, device=DEVICE) if wg else None
        checks = [("trilinear_fwd", list(zip(grid_ops.trilinear_fwd(grid, pts, lo, hi, wg),
                                             grid_ops.trilinear_fwd_plain(grid, pts, lo, hi, wg))))]
        if lookup_bwd:
            checks.append(("trilinear_bwd", list(zip(
                grid_ops.trilinear_bwd(grid, pts, lo, hi, ct_v, ct_g, True, True),
                grid_ops.trilinear_bwd_plain(grid, pts, lo, hi, ct_v, ct_g, True, True)))))
        torch.cuda.synchronize()
        for name, pairs in checks:
            worst[name] = max([worst[name]] + [_tri_close(f"{label} lookup {i} {name} against its plain version", a, b)
                                               for a, b in pairs if a is not None])
    for i, (enc, w, b, L, skip) in enumerate(calls):
        n = enc.shape[0]
        f_abs, f_rel = _max_err(fused_mlp.trunk_fwd(enc, w, b, L, skip), fused_mlp.trunk_fwd_plain(enc, w, b, L, skip))
        feat, _, acts = fused_mlp.trunk_fwd_plain(enc, w, b, L, skip)
        g = torch.Generator(device=DEVICE).manual_seed(200 + i)
        g_feat = (torch.randn(feat.shape, generator=g, device=DEVICE) * 1e-3).to(torch.bfloat16)
        g_dens = (torch.randn(n, generator=g, device=DEVICE) * 1e-3).to(torch.bfloat16)
        b_abs, b_rel = _max_err(fused_mlp.trunk_bwd(enc, g_feat, g_dens, feat, acts, w, b, L, skip),
                                fused_mlp.trunk_bwd_plain(enc, g_feat, g_dens, feat, acts, w, b, L, skip))
        print(f"{label} trunk call {i} (N={n}, its own inputs): fwd max abs err {f_abs:.3e} ({f_rel:.3e} of max "
              f"|plain|), bwd max abs err {b_abs:.3e} ({b_rel:.3e} of max |plain|), tolerance {REL_TOL} of max")
        if not (f_rel <= REL_TOL and b_rel <= REL_TOL):
            raise AssertionError(f"{label}: trunk kernel disagrees with its plain version at N={n}")
        worst["trunk_fwd"], worst["trunk_bwd"] = max(worst["trunk_fwd"], f_abs), max(worst["trunk_bwd"], b_abs)
    if not (lookups or calls):
        raise AssertionError(f"{label}: nothing was captured")
    print(f"{label} kernels against their plain versions at {len(lookups)} lookups and {len(calls)} "
          f"trunk call(s): worst max abs err " + json.dumps({k: float(f"{v:.3e}") for k, v in worst.items()}))
    return worst


def _launch_counters(fused_mlp, grid_ops):
    def counts():
        return {"trunk_fwd": fused_mlp.fwd_launches, "trunk_bwd": fused_mlp.bwd_launches,
                "trilinear_fwd": grid_ops.fwd_launches, "trilinear_bwd": grid_ops.bwd_launches}

    def reset():
        fused_mlp.fwd_launches = fused_mlp.bwd_launches = 0
        grid_ops.fwd_launches = grid_ops.bwd_launches = 0
    return counts, reset


def drive_preset(mods: dict, trainer_mod, root: str) -> tuple[dict, dict, tuple]:
    """The published `dtu_generic` preset trained from a DTU-layout dataset on
    disk (written to `root`, where it stays for `drive_cli`): the port's
    loader, matcher and feature maps, `fit()` from step 0 across the
    activation of view 2 in superstep windows, then one superstep window past
    the last `pg_scale` doubling, where the surface-feature term runs on the
    96^3 grid, after the kernels are held against their plain versions at
    that step's shapes. Returns the kernels' launch counts of both runs,
    those checks' worst errors, and (config, data, the rendered scene)."""
    from poseprobe_tpu_torch.config.presets import dtu_generic
    from poseprobe_tpu_torch.data import loaders, synthetic
    from poseprobe_tpu_torch.eval.vgg_features import get_multi_features
    from poseprobe_tpu_torch.pose_init import matching
    from tools.dtu_fixture import write_dtu
    fused_mlp, grid_ops = mods["fused_mlp"], mods["grid"]
    counts, reset = _launch_counters(fused_mlp, grid_ops)

    H, W = PRESET_HW
    t0 = time.perf_counter()
    scene, on_disk = _dtu_fixture(synthetic, H, W)
    t_render = time.perf_counter() - t0
    t0 = time.perf_counter()
    write_dtu(root, on_disk)
    t_write = time.perf_counter() - t0
    cfg = dtu_generic.get_config(datadir=root, selected_id=(1, 2, 3))
    cfg = dataclasses.replace(cfg, camera=dataclasses.replace(cfg.camera, incremental_step=12))
    t0 = time.perf_counter()
    data = loaders.load_dtu(cfg.data)
    t_load = time.perf_counter() - t0
    # matching and feature maps timed apart, each called once more on the loaded views
    t0 = time.perf_counter()
    matching.build_match_packs(data.images, data.masks, data.i_train, data.pair_j, max_matcher=cfg.data.max_matcher)
    t_match = time.perf_counter() - t0
    t0 = time.perf_counter()
    maps = get_multi_features(data.images[data.i_train], device=DEVICE)
    torch.cuda.synchronize()
    t_feat = time.perf_counter() - t0
    del maps
    packs = {k: [int(n) for n in (getattr(data, k)[..., 4] > 0).sum(axis=1)]
             for k in ("obj_matches", "scene_matches", "ba_matches")}
    if matching._HAS_CV2:
        matcher = "classical (OpenCV SIFT, mutual ratio test)"
    else:
        matcher = "none: OpenCV not found, the classical matcher returned zero packs; trained on the fixture's analytic packs"
        data.obj_matches, data.scene_matches = scene.obj_matches, scene.scene_matches
        data.ba_matches, data.ba_pairs = scene.ba_matches, scene.ba_pairs
    used = {k: [int(n) for n in (getattr(data, k)[..., 4] > 0).sum(axis=1)]
            for k in ("obj_matches", "scene_matches", "ba_matches")}
    if not (data.images.shape == (4, H, W, 3) and list(data.i_train) == [0, 1, 2]
            and list(data.i_test) == [3] and data.masks.shape == (4, H, W, 1)):
        raise AssertionError(f"the DTU fixture did not load as three train views and one test view of "
                             f"{H}x{W}: {data.images.shape}, {data.i_train}, {data.i_test}")
    if min(min(v) for v in used.values()) == 0:
        raise AssertionError(f"a match pack of the preset's data is empty: {used}")
    t0 = time.perf_counter()
    tr = trainer_mod.JointTrainer(cfg, data, device=DEVICE)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    om, ot, sm = tr.cfg.object_model, tr.cfg.object_train, tr.cfg.scene_model
    print(f"preset dtu_generic: {H}x{W} DTU-layout scan of {PRESET_VIEWS} views rendered in {t_render:.1f} s, "
          f"written in {t_write:.2f} s; load {t_load:.2f} s (its matching included); matching alone "
          f"(build_match_packs, called again) {t_match:.2f} s ({matcher}): matches per pack found {packs}, trained "
          f"on {used}; feature maps {tuple(tr.feature_maps.shape)} (get_multi_features, called again) {t_feat:.3f} "
          f"s; trainer built in {t_build:.2f} s (PnP chain and feature maps); grid {om.world_size} "
          f"(pg_scale {ot.pg_scale}), {ot.N_rand} object rays, {sm.rand_rays} scene rays, {sm.sample_intvs}+"
          f"{sm.sample_intvs_fine} samples, trunk {len(sm.layers_feat)}x{sm.layers_feat[0]} {sm.matmul_dtype}")
    if not (fused_mlp.supports(sm) and sm.matmul_dtype == "bfloat16" and om.use_maskcache
            and ot.weight_surface_projection > 0):
        raise AssertionError("the dtu_generic preset does not take the fused trunk, the mask cache and the feature term")

    # fit from step 0 across the activation of view 2 (step 12), in superstep windows
    n_steps = 20
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    hist = [dict(h) for h in tr.fit(n_steps, log_every=SUPERSTEP, superstep=SUPERSTEP)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    fit_counts = counts()
    print(f"preset fit: {n_steps} steps in {dt:.2f} s (activation event included); launches {fit_counts}; "
          f"feat_loss {[round(h['feat_loss'], 5) for h in hist]}, feature rays {[h['feat_rays'] for h in hist]}, "
          f"active views {[(h['step'], h['n_active']) for h in hist]}")
    if not (tr.n_active == 3 and all(math.isfinite(v) for h in hist for v in h.values())
            and all("feat_loss" in h for h in hist)):
        raise AssertionError("the preset's fit did not activate view 2, or a metric is non-finite or missing")
    if min(v for v in fit_counts.values()) < n_steps:
        raise AssertionError(f"a kernel of the preset's step was launched less than once a step: {fit_counts}")

    # past the last pg_scale doubling (its grid rescales and mask-cache refreshes run as `fit` runs
    # them): the feature term on the full 96^3 grid, inside the pose window and the object phase
    last = max(ot.pg_scale)
    tr.global_step = last
    for s in ot.pg_scale:
        tr.maybe_pg_scale(s)
    tr.global_step = last + 1
    flags = tr.phase_flags(tr.global_step)
    if not (tr.cfg.object_model.num_voxels == tr._final_num_voxels and flags["object_on"] and flags["pose_on"]
            and tr._feature_term_on(flags)):
        raise AssertionError(f"step {tr.global_step} is not a full-grid object step with the feature term: {flags}")
    errs = check_path_kernels(fused_mlp, grid_ops, tr, "preset")
    torch.cuda.reset_peak_memory_stats()
    start = tr.global_step
    graph = check_superstep(tr, "preset", counts, reset)
    steps = {k: v / SUPERSTEP for k, v in graph.items()}
    reset()
    window = tr.steps_scan(SUPERSTEP)
    torch.cuda.synchronize()
    feat = [float(v) for v in window["feat_loss"]]
    rays = [int(v) for v in window["feat_rays"]]
    replayed = counts()
    print(f"preset step {start} (grid {tr.cfg.object_model.world_size}, object_on, pose_on, feature term on), a "
          f"graph window: feat_loss {feat}, valid feature rays {rays} of {min(256, ot.N_rand)}; launches per step: "
          f"trilinear fwd {steps['trilinear_fwd']:g} bwd {steps['trilinear_bwd']:g}, trunk fwd {steps['trunk_fwd']:g} "
          f"bwd {steps['trunk_bwd']:g}")
    if not (all(math.isfinite(x) for x in feat) and min(rays) > 0):
        raise AssertionError("the feature term had no valid ray, or a non-finite value, in the graph window")
    # per step: the trunk once each way (the coarse scene render); the trilinear forward for the render's
    # two lookups, the reprojection query and the feature term's two surface queries, its backward for
    # all but the cycle check's query, which takes no gradient
    if steps != {"trunk_fwd": 1, "trunk_bwd": 1, "trilinear_fwd": 5, "trilinear_bwd": 4} or replayed != graph:
        raise AssertionError(f"the preset's graph windows did not launch the kernels of its step: {graph}, {replayed}")
    # step time eager and in graph windows (in turns), device time under torch.profiler
    from poseprobe_tpu_torch import profile_step
    prof = profile_step.profile_phase(tr, "preset", start, 8, SUPERSTEP, None)
    print(json.dumps({k: v for k, v in prof.items() if k not in ("eager", "graph")}
                     | {m: {k: v for k, v in prof[m].items() if k not in ("top", "top_host_ops")}
                        for m in ("eager", "graph")}))
    return {"preset": fit_counts, "preset_graph": graph}, errs, (cfg, data, scene)


# The CLI phase: the training run's flags (full width; depth cut to 40 steps with the schedule
# resolved against them, pg_scale's doublings moved to steps 8, 16 and 24 and the view
# activation to step 12, so that the run crosses all of them), the resume check's steps and the
# video's frames (the CLI renders 40-60)
CLI_FLAGS = ["--steps", "40", "--pg_scale", "8,16,24", "--incremental_step", "12", "--superstep", "4",
             "--i_ckpt", "20", "--i_print", "4"]
RESUME_AT, RESUME_STEPS = 13, 16
VIDEO_FRAMES = 3
EVAL_RES = 256                         # the evaluation CLI's volume
# `dtu_generic` on the fixture scan's views: the preset's own train views (22, 25, 28) are not in a
# four-view scan, and the CLIs take the view selection from the preset, as the reference's do
FIXTURE_PRESET = """from poseprobe_tpu_torch.config.presets import dtu_generic


def get_config(datadir: str = "", scan_id: int = 2):
    return dtu_generic.get_config(datadir=datadir, scan_id=scan_id, selected_id=(1, 2, 3))
"""


def check_eval_kernels(fused_mlp, grid_ops, tr, data) -> dict:
    """The trunk and trilinear kernels against their plain versions at the
    evaluation path's shapes, on `tr`'s state: each trunk call of one
    `render_full` chunk (4096 rays: a 64x64 image is one chunk) and of one
    test-time iteration (1024 rays; the backward under random cotangents),
    the trilinear value at one `extract_sdf_volume` chunk (65,536 points) and
    the lookups of one `mesh_color_forward` chunk (65,536 vertices: the SDF's
    value+grad and the k0 value). Returns the worst max abs error by kernel."""
    from poseprobe_tpu_torch.eval import evaluator
    from poseprobe_tpu_torch.models import object_sdf
    calls, lookups, saved = [], [], (fused_mlp.trunk_fwd, grid_ops.trilinear_sample, grid_ops.trilinear_sample_with_grad)

    def watch_trunk(enc, w, b, L, skip, store_acts=True):
        calls.append((enc.detach().clone(), w.detach().clone(), b.detach().clone(), L, skip))
        return saved[0](enc, w, b, L, skip, store_acts)

    def watch_lookup(fn, with_grad):
        def call(grid, xyz, lo, hi):
            if xyz.reshape(-1, 3).shape[0] == 65536:
                lookups.append((tuple(grid.shape), with_grad, xyz.detach().reshape(-1, 3).clone(),
                                torch.as_tensor(lo, device=DEVICE).float(), torch.as_tensor(hi, device=DEVICE).float()))
            return fn(grid, xyz, lo, hi)
        return call

    sm, om, i = tr.cfg.scene_model, tr.cfg.object_model, int(data.i_test[0])
    progress = min(tr.global_step / sm.max_iter, 1.0)
    pose = tr.current_pose_host()[0]
    fused_mlp.trunk_fwd = watch_trunk
    grid_ops.trilinear_sample, grid_ops.trilinear_sample_with_grad = watch_lookup(saved[1], False), watch_lookup(saved[2], True)
    try:
        evaluator.render_full(tr.scene_params, sm, pose, data.Ks[i], 64, 64, (data.near, data.far), progress=progress)
        n_render = len(calls)
        evaluator.test_time_pose_optim(tr.scene_params, sm, pose, data.Ks[i], data.images[i], (data.near, data.far),
                                       n_iters=1, progress=progress)
        object_sdf.extract_sdf_volume(tr.obj_params, om, resolution=41)          # 68,921 points: one full chunk
        verts = torch.rand((65536, 3), generator=torch.Generator().manual_seed(0)).numpy() * 0.6 - 0.3
        object_sdf.mesh_color_forward(tr.obj_params, om, verts)
    finally:
        fused_mlp.trunk_fwd, grid_ops.trilinear_sample, grid_ops.trilinear_sample_with_grad = saved
    torch.cuda.synchronize()
    print(f"eval path captured: render_full chunk trunk calls N={[c[0].shape[0] for c in calls[:n_render]]}, test-time "
          f"iteration trunk calls N={[c[0].shape[0] for c in calls[n_render:]]}, lookups "
          + ", ".join(f"grid {list(gs)}{' value+grad' if wg else ''}: {p.shape[0]} points" for gs, wg, p, _, _ in lookups))
    if not (n_render and len(calls) > n_render and len(lookups) == 3):
        raise AssertionError(f"the eval path made {n_render} / {len(calls) - n_render} trunk calls and "
                             f"{len(lookups)} lookups of a chunk")
    return _hold_captured(fused_mlp, grid_ops, lookups, calls, "eval", lookup_bwd=False)


def _host_state(tr) -> tuple:
    """What a step reads besides `state_tensors()`: the step, the active
    views, the config, the mask-cache budgets and the generator's state."""
    return (tr.global_step, tr.n_active, tr.cfg, tr._mask_k, tr._k_phase, bytes(tr.generator.get_state().numpy()))


def _copy_state(tr, state: list, host: tuple, what: str) -> None:
    """Copy `state` (another trainer's `state_tensors()`) into `tr`'s in
    place, after holding `tr`'s host state to `host`, that trainer's."""
    mine = tr.state_tensors()
    if not (_host_state(tr) == host and len(mine) == len(state)
            and all(x.dtype == y.dtype and x.shape == y.shape for x, y in zip(mine, state))):
        raise AssertionError(f"{what}: the host state or the state's shapes differ from the run copied from")
    with torch.no_grad():
        for x, y in zip(mine, state):
            x.copy_(y)


def _check_resume(trainer_mod, state_mod, cfg, data, path: str) -> dict:
    """Fit a trainer A from step 0 to RESUME_AT in superstep windows (across
    the doubling at 8 and the activation at 12) and save it; load the file into
    fresh trainers B and C. Held: B's state right after the load is A's at the
    save, bit for bit (every state tensor, the generator's state, the step, the
    views, the voxel count, the mask-cache budgets); the steps up to the next
    doubling (RESUME_AT to 16) agree between A and B as a graph window agrees
    with eager steps in `check_superstep` (losses within GRAPH_LOSS_RTOL, each
    parameter within REL_TOL in the L2 norm relative to its own). Then all
    three run on to RESUME_AT + RESUME_STEPS across the doublings at 16 and 24
    (done with B's and C's host state) in the logging windows, each started
    by B and C from A's state (`_copy_state`, which holds their host state,
    generator included, equal to A's), so that a window parts the runs only
    by its own atomics: after a doubling Adam restarts and normalises each
    element's first step, so that the atomics' run-dependent order of
    summation moves near-cancelling elements by up to 2 lr either way, and
    runs left to part for 13 steps differ by up to 22% in loss. A against B
    (the resume) is held to what B against C (two runs from one state) shows
    in the same window, times 3, or REL_TOL (GRAPH_LOSS_RTOL for losses), in
    every window."""
    from poseprobe_tpu_torch.core.tree import tree_leaves
    first = min(s for s in cfg.object_train.pg_scale + (RESUME_AT + RESUME_STEPS,) if s > RESUME_AT)

    def trainer(restored: bool):
        tr = trainer_mod.JointTrainer(cfg, data, device=DEVICE)
        if restored:
            state_mod.restore_state(tr, state_mod.load_checkpoint(path))
        return tr

    def params(tr):
        return [t.clone() for n in tr.GROUPS for t in tree_leaves(getattr(tr, f"{n}_params"))]

    def rel_l2(pa, pb):
        return max(float((x - y).norm()) / max(float(y.norm()), 1e-30) for x, y in zip(pa, pb))

    def run(tr, n):
        start = tr.global_step
        hist = tr.fit(n, log_every=SUPERSTEP, superstep=SUPERSTEP)
        torch.cuda.synchronize()
        return {h["step"]: h["loss_total"] for h in hist if h["step"] > start}, params(tr)

    def loss_rel(la, lb):
        return max((abs(la[k] - lb[k]) / abs(la[k]) for k in la if k in lb), default=0.0)

    a = trainer(False)
    a.fit(RESUME_AT, log_every=SUPERSTEP, superstep=SUPERSTEP)
    state_mod.save_checkpoint(path, a, extras=a.host_extras())
    saved = ([t.clone() for t in a.state_tensors()], _host_state(a))
    b = trainer(True)
    loaded = b.state_tensors()
    if not (_host_state(b) == saved[1] and len(loaded) == len(saved[0])
            and all(x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y) for x, y in zip(loaded, saved[0]))):
        raise AssertionError("resume: the loaded state is not the saved state bit for bit")
    (la, pa), (lb, pb) = run(a, first - RESUME_AT), run(b, first - RESUME_AT)
    early = (loss_rel(la, lb), rel_l2(pb, pa))
    c = trainer(True)
    run(c, first - RESUME_AT)
    windows = []
    while a.global_step < RESUME_AT + RESUME_STEPS:
        n = min(SUPERSTEP - a.global_step % SUPERSTEP, RESUME_AT + RESUME_STEPS - a.global_step)
        start = ([t.clone() for t in a.state_tensors()], _host_state(a))
        for name, tr in (("B", b), ("C", c)):
            _copy_state(tr, *start, f"resume: {name} at step {a.global_step}")
        (la, pa), (lb, pb), (lc, pc) = run(a, n), run(b, n), run(c, n)
        windows.append({"to_step": a.global_step, "resume_loss_rel": loss_rel(la, lb),
                        "resume_param_rel_l2": rel_l2(pb, pa), "rerun_loss_rel": loss_rel(lc, lb),
                        "rerun_param_rel_l2": rel_l2(pc, pb)})
    out = {"saved_at": RESUME_AT, "state_bit_equal": True, "to_step": first, "loss_rel": early[0],
           "param_rel_l2": early[1], "late_windows": windows,
           "host_equal": _host_state(a) == _host_state(b) == _host_state(c),
           "num_voxels": a.cfg.object_model.num_voxels}
    print("resume through a checkpoint against the run without the break: " + json.dumps(out))
    if not (early[0] <= GRAPH_LOSS_RTOL and early[1] <= REL_TOL and out["host_equal"]
            and all(w["resume_param_rel_l2"] <= max(REL_TOL, 3 * w["rerun_param_rel_l2"])
                    and w["resume_loss_rel"] <= max(GRAPH_LOSS_RTOL, 3 * w["rerun_loss_rel"]) for w in windows)):
        raise AssertionError("the resumed run disagrees with the run without the break")
    return out


def drive_cli(mods: dict, trainer_mod, root: str, preset: tuple) -> tuple[dict, dict]:
    """The two CLIs on `drive_preset`'s scan, in a working directory of their
    own: `run` trains `dtu_generic` (through a preset file that selects the
    scan's views) at full width for 40 steps across three doublings, the
    activation of view 2 and the phase flips at step 12, writing checkpoints,
    the test-set evaluation and the mesh; the checkpoint's size and its write
    and read times; a resume through a checkpoint against the run without the
    break; `evaluate` on the run's last checkpoint (with and without
    test-time optimization, the mesh from a 256^3 volume); a full render, a
    test-time optimization, the 256^3 volume and the marching timed apart,
    with their launches; the synthetic pair (`run --synthetic --steps 20`,
    `evaluate --synthetic --eval_mesh` with its chamfer, on one test view);
    VIDEO_FRAMES frames
    of the spiral video at 1600x1200; the kernels held at the eval path's
    shapes. Returns the launches by part and the kernel checks' worst errors."""
    from poseprobe_tpu_torch import evaluate as evaluate_cli, run as run_cli
    from poseprobe_tpu_torch.eval import evaluator, mesh as mesh_mod, video as video_mod
    from poseprobe_tpu_torch.models import object_sdf
    from poseprobe_tpu_torch.pose_init import matching
    from poseprobe_tpu_torch.train import state as state_mod
    fused_mlp, grid_ops = mods["fused_mlp"], mods["grid"]
    _, data, _ = preset
    counts, reset = _launch_counters(fused_mlp, grid_ops)

    def timed(fn):
        torch.cuda.synchronize()
        reset()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, counts()

    work = os.path.join(os.path.dirname(os.path.dirname(root)), "cli")
    os.makedirs(work)
    preset_file = os.path.join(work, "dtu_fixture_views.py")
    with open(preset_file, "w") as f:
        f.write(FIXTURE_PRESET)
    flags = ["--config", preset_file, "--datadir", root]
    cwd = os.getcwd()
    os.chdir(work)
    try:
        print(f"cli: matching {'OpenCV SIFT' if matching._HAS_CV2 else 'none (no OpenCV: empty match packs)'}")
        _, run_s, run_counts = timed(lambda: run_cli.main(flags + CLI_FLAGS + ["--render_test", "--export_mesh"]))
        args = run_cli.build_parser().parse_args(flags + CLI_FLAGS)
        cfg = run_cli.apply_overrides(run_cli.load_config(args), args)
        out_dir = os.path.join(work, cfg.basedir, cfg.expname)
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        ms = [(b["wall"] - a["wall"]) / (b["step"] - a["step"]) * 1e3 for a, b in zip(rows, rows[1:])]
        with open(os.path.join(out_dir, f"{cfg.expname}.json")) as f:
            test_res = json.load(f)
        print(f"cli run: 40 steps in {run_s:.2f} s wall in all (data load, trainer build, fit, 3 checkpoints, the "
              f"test-set evaluation, the 128^3 mesh); ms/step between logs (4 steps each, host events "
              f"included): {[round(x, 1) for x in ms]}; launches {run_counts}; test set: "
              + json.dumps({k: test_res[k] for k in ("psnr", "ssim", "rot_error", "trans_error")}))
        ckpt = os.path.join(out_dir, "last_ckpt.pkl")
        if not ([r["step"] for r in rows] == list(range(4, 41, 4)) and rows[-1]["n_active"] == 3
                and all(math.isfinite(r["loss_total"]) for r in rows)
                and os.path.exists(os.path.join(out_dir, "meshes", "deform_final.ply")) and os.path.exists(ckpt)
                and min(run_counts.values()) > 0):
            raise AssertionError(f"the CLI run did not log 40 steps with view 2 active and write its outputs: {rows}")

        # the checkpoint: read into a trainer of the run's config, then written again
        tr = trainer_mod.JointTrainer(cfg, data, device=DEVICE)
        (_, read_s, _) = timed(lambda: state_mod.restore_state(tr, state_mod.load_checkpoint(ckpt)))
        again = os.path.join(work, "again.npz")
        (_, write_s, _) = timed(lambda: state_mod.save_checkpoint(again, tr, extras=tr.host_extras()))
        print(f"checkpoint: {os.path.getsize(ckpt)} bytes, read and restored in {read_s:.3f} s, written in "
              f"{write_s:.3f} s ({os.path.getsize(again)} bytes); restored step {tr.global_step}, grid "
              f"{tr.cfg.object_model.world_size}")
        if not (tr.global_step == 40 and tr.cfg.object_model.num_voxels == tr._final_num_voxels):
            raise AssertionError("the restored trainer is not at step 40 with the full grid")
        resume = _check_resume(trainer_mod, state_mod, cfg, data, os.path.join(work, "resume.npz"))

        # the evaluation CLI on the run's last checkpoint
        _, eval_s, eval_counts = timed(lambda: evaluate_cli.main(flags + ["--ckpt", ckpt, "--eval_mesh"]))
        with open(os.path.join(out_dir, "eval", f"{cfg.expname}.json")) as f:
            ev = json.load(f)
        print(f"cli evaluate: {eval_s:.2f} s; launches {eval_counts}; " + json.dumps(
            {m: {k: ev[m][k] for k in ("psnr", "ssim", "rot_error", "trans_error")}
             for m in ("w_test_optim", "without_test_optim")} | {"iteration": ev["iteration"]}))
        if not (ev["iteration"] == 40 and eval_counts["trunk_fwd"] > 0 and eval_counts["trunk_bwd"] > 0
                and eval_counts["trilinear_fwd"] > 0 and os.path.exists(os.path.join(out_dir, "eval", "mesh.ply"))):
            raise AssertionError(f"the evaluation CLI did not run through the kernels or write its mesh: {eval_counts}")

        # its parts, timed apart on the restored trainer
        sm, om, i = tr.cfg.scene_model, tr.cfg.object_model, int(data.i_test[0])
        progress = min(tr.global_step / sm.max_iter, 1.0)
        cur = tr.current_pose_host()
        _, sim3 = evaluator.align_train_poses(cur, data.poses_gt_w2c[data.i_train])
        from poseprobe_tpu_torch.core import align
        pose = align.backtrack_from_aligning_the_trajectory(data.poses_gt_w2c[i:i + 1], sim3)[0]
        rng = (data.near, data.far)
        out, render_s, render_counts = timed(lambda: evaluator.render_full(
            tr.scene_params, sm, pose, data.Ks[i], data.H, data.W, rng, progress=progress))
        _, tto_s, tto_counts = timed(lambda: evaluator.test_time_pose_optim(
            tr.scene_params, sm, pose, data.Ks[i], data.images[i], rng, n_iters=tr.cfg.scene_train.test_iter,
            progress=progress))
        vol, vol_s, vol_counts = timed(lambda: object_sdf.extract_sdf_volume(tr.obj_params, om, resolution=EVAL_RES))
        t0 = time.perf_counter()
        verts, tris = mesh_mod.extract_mesh_world(vol, om.xyz_min_np, om.xyz_max_np, scale_mat=data.scale_mats)
        march_s = time.perf_counter() - t0
        parts = {"render_full": render_counts, "test_time_optim": tto_counts, "sdf_volume": vol_counts}
        print(f"eval parts: full render {data.H}x{data.W} {render_s:.3f} s (launches {render_counts}); test-time "
              f"optimization ({tr.cfg.scene_train.test_iter} iterations of 1024 rays) {tto_s:.3f} s (launches "
              f"{tto_counts}); the {EVAL_RES}^3 volume {vol_s:.3f} s (launches {vol_counts}); marching tetrahedra "
              f"({mesh_mod.native_path()}) {march_s:.3f} s: {len(verts)} vertices, {len(tris)} triangles")
        # device time of one unit of each (torch.profiler), and the share of the host seconds above it fills
        n_chunks = -(-data.H * data.W // 4096)
        units = {
            "render_full chunk (4096 rays)": (lambda: evaluator.render_full(
                tr.scene_params, sm, pose, data.Ks[i], 64, 64, rng, progress=progress), n_chunks, render_s),
            "test-time iteration (1024 rays)": (lambda: evaluator.test_time_pose_optim(
                tr.scene_params, sm, pose, data.Ks[i], data.images[i], rng, n_iters=1, progress=progress),
                tr.cfg.scene_train.test_iter, tto_s),
            "40^3 volume (64,000 points, one chunk)": (lambda: object_sdf.extract_sdf_volume(
                tr.obj_params, om, resolution=40), EVAL_RES ** 3 / 40 ** 3, vol_s)}
        for name, (fn, n, host_s) in units.items():
            ms, n_events, _ = _device_profile(fn, iters=5)
            print(f"eval device time: {name} {ms:.3f} ms in {n_events:.0f} device events; x{n:g} = "
                  f"{ms * n / 1e3:.3f} s of the call's {host_s:.3f} s host seconds ({ms * n / 1e3 / host_s:.1%} busy)")
        if not (render_counts["trunk_fwd"] > 0 and tto_counts["trunk_bwd"] >= tr.cfg.scene_train.test_iter
                and vol_counts["trilinear_fwd"] == -(-EVAL_RES ** 3 // 65536) and torch.isfinite(out["rgb"]).all()):
            raise AssertionError(f"an eval part did not launch its kernels: {parts}")

        # the synthetic pair
        _, syn_s, _ = timed(lambda: run_cli.main(["--synthetic", "--steps", "20", "--n_test", "1"]))
        syn_ckpt = os.path.join(work, "logs", "synthetic", "last_ckpt.pkl")
        _, syn_eval_s, _ = timed(lambda: evaluate_cli.main(["--synthetic", "--n_test", "1", "--ckpt", syn_ckpt,
                                                            "--eval_mesh"]))
        with open(os.path.join(work, "logs", "synthetic", "eval", "chamfer.json")) as f:
            chamfer = json.load(f)
        print(f"synthetic pair: run 20 steps {syn_s:.2f} s, evaluate {syn_eval_s:.2f} s; chamfer.json "
              + json.dumps(chamfer))
        if not ({"d2s", "s2d", "overall"} <= set(chamfer) or chamfer.get("error") == "empty mesh"):
            raise AssertionError(f"the synthetic evaluation wrote no chamfer: {chamfer}")

        # the video, VIDEO_FRAMES frames of the CLI's spiral
        poses = run_cli.spiral_w2c(cur, 60)[:VIDEO_FRAMES]
        written, video_s, _ = timed(lambda: video_mod.render_video(
            tr.scene_params, sm, poses, data.Ks[data.i_train[0]], data.H, data.W, rng,
            os.path.join(work, "video", "spiral_rgb.mp4"), depth_out_path=os.path.join(work, "video", "spiral_depth.mp4")))
        print(f"video: {VIDEO_FRAMES} frames at {data.H}x{data.W} in {video_s:.2f} s, {video_s / VIDEO_FRAMES:.3f} "
              f"s per frame (rgb and coloured depth), written to {os.path.relpath(written, work)}")
        errs = check_eval_kernels(fused_mlp, grid_ops, tr, data)
    finally:
        os.chdir(cwd)
    return {"cli": run_counts, "cli_eval": eval_counts, **{f"eval_{k}": v for k, v in parts.items()}}, errs


# The last single-card paths (`drive_last_paths`): the TensoRF early step, depth consistency from
# fresh pixels in the mid step, the SuperGlue matcher on the preset's scan, and the CLI over them.
# The TensoRF cell's steps: one eager step held against the plain versions, SUPERSTEP-step graph
# windows; the SuperGlue trainer's fit steps; the CLI run's steps (synthetic scene, full width).
TENSORF_STEPS = 4
SG_FIT_STEPS = 8
CLI13_FLAGS = ["--synthetic", "--grid_type", "tensorf", "--match_source", "superglue", "--matcher", "superglue",
               "--steps", "8", "--superstep", "4", "--i_print", "4", "--n_test", "1"]
SG_REL_TOL = 1e-4                      # SuperPoint maps (of max |CPU|) and SuperGlue's log assignment (abs)


def _profile(tr, name: str) -> None:
    """The cell's eager steps and graph windows in turns, then traced
    (`profile_step.profile_phase`): step ms, device ms, device events per
    step; printed, and as one JSON line."""
    from poseprobe_tpu_torch import profile_step
    prof = profile_step.profile_phase(tr, name, tr.global_step, 8, SUPERSTEP, None)
    print(json.dumps({k: v for k, v in prof.items() if k not in ("eager", "graph")}
                     | {m: {k: v for k, v in prof[m].items() if k not in ("top", "top_host_ops")}
                        for m in ("eager", "graph")}))


def _eager_steps(tr, n: int, counts, reset) -> tuple[float, dict, list]:
    """`n` eager steps after two warm ones: (ms per step, launches, metrics)."""
    for _ in range(2):
        tr.step()
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    metrics = [tr.step() for _ in range(n)]
    torch.cuda.synchronize()
    if not all(math.isfinite(float(v)) for m in metrics for v in m.values()):
        raise AssertionError("non-finite metrics in an eager step")
    return (time.perf_counter() - t0) / n * 1e3, counts(), metrics


def _loss_against_plain(tr, loss_fn, grid_ops) -> tuple[float, float]:
    """One step's loss through the kernels, against the same step through the
    plain lookups (rel diff, tolerance 1e-5) and through the plain trunk (rel
    diff, tolerance REL_TOL), on one set of draws."""
    flags = tr.phase_flags(tr.global_step)
    draws = tr.sample_draws(flags)
    sm = tr.cfg.scene_model
    with torch.no_grad():
        fused = float(loss_fn(flags, draws))
        kernels = grid_ops.trilinear_sample, grid_ops.trilinear_sample_with_grad
        grid_ops.trilinear_sample = grid_ops.trilinear_sample_reference
        grid_ops.trilinear_sample_with_grad = grid_ops.trilinear_vg_reference
        try:
            plain_lookup = float(loss_fn(flags, draws))
        finally:
            grid_ops.trilinear_sample, grid_ops.trilinear_sample_with_grad = kernels
        tr.cfg = dataclasses.replace(tr.cfg, scene_model=dataclasses.replace(sm, use_fused_trunk=False))
        try:
            plain_trunk = float(loss_fn(flags, draws))
        finally:
            tr.cfg = dataclasses.replace(tr.cfg, scene_model=sm)
    return abs(fused - plain_lookup) / abs(plain_lookup), abs(fused - plain_trunk) / abs(plain_trunk)


def drive_tensorf(mods: dict, trainer_mod, work: str) -> tuple[dict, dict]:
    """`build_trainer()`'s early step with ``grid_type="tensorf"``: eager
    steps, the kernels held at the step's lookups and trunk calls, one step
    against the plain versions, a graph window against eager steps and its
    profile, the device time of `tensorf_sample` with its backward beside the
    dense 12-channel lookup at the same points, one doubling through
    `tensorf_resize` after which the next window captures again, and a
    checkpoint written and read back bit for bit."""
    from poseprobe_tpu_torch.core.tree import tree_leaves
    from poseprobe_tpu_torch.ops import tensorf
    from poseprobe_tpu_torch.train import state as state_mod
    fused_mlp, grid_ops = mods["fused_mlp"], mods["grid"]
    counts, reset = _launch_counters(fused_mlp, grid_ops)
    cfg, data = trainer_mod._bench_workload(SMALL, "bfloat16")
    cfg = dataclasses.replace(cfg, object_model=dataclasses.replace(cfg.object_model, grid_type="tensorf"))
    t0 = time.perf_counter()
    tr = trainer_mod.JointTrainer(cfg, data, device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    om, ot = tr.cfg.object_model, tr.cfg.object_train
    tr.global_step = 1
    flags = tr.phase_flags(1)
    k0 = tr.obj_params["k0_grid"]
    if not (flags["object_on"] and isinstance(k0, dict) and tr._mask_k):
        raise AssertionError("the TensoRF workload does not start in the early phase with a TensoRF k0")
    ms, eager, metrics = _eager_steps(tr, TENSORF_STEPS, counts, reset)
    per_step = {k: v / TENSORF_STEPS for k, v in eager.items()}
    print(f"tensorf early (grid {om.world_size}, k0 {om.tensorf_n_comp} components x {om.rgbnet_dim} channels: "
          + ", ".join(f"{k} {tuple(v.shape)}" for k, v in k0.items()) + f"; trainer built in {build_s:.2f} s; "
          f"{ot.N_rand} object rays x {tr._mask_k} of {om.n_samples} lanes): eager {ms:.2f} ms/step, loss "
          f"{float(metrics[0]['loss_total']):.5f} -> {float(metrics[-1]['loss_total']):.5f}, psnr_obj "
          f"{float(metrics[-1]['psnr_obj']):.3f}; launches per step {per_step}")
    # per step: the coarse scene render's trunk; the SDF's 1-channel value+gradient lookup at the deformed
    # points, its value at the points (no merged 13-channel lookup: k0 is TensoRF) and the reprojection query
    if per_step != {"trunk_fwd": 1, "trunk_bwd": 1, "trilinear_fwd": 3, "trilinear_bwd": 3}:
        raise AssertionError(f"the TensoRF step did not launch the kernels of its lookups: {per_step}")
    errs = check_path_kernels(fused_mlp, grid_ops, tr, "tensorf")
    rel_lookup, rel_trunk = _loss_against_plain(
        tr, lambda f, d: tr.joint_loss(tr.obj_params, tr.scene_params, tr.pose_params, tr.global_step, f, d)[0],
        grid_ops)
    print(f"tensorf step loss through the kernels against the plain lookups: rel diff {rel_lookup:.2e} (tolerance "
          f"1e-5); against the plain trunk: rel diff {rel_trunk:.2e} (tolerance {REL_TOL})")
    if not (rel_lookup <= 1e-5 and rel_trunk <= REL_TOL):
        raise AssertionError("the TensoRF step's loss through the kernels disagrees with the plain versions'")
    graph = check_superstep(tr, "tensorf", counts, reset)
    if graph != {k: v * SUPERSTEP for k, v in per_step.items()}:
        raise AssertionError(f"the TensoRF graph window did not launch the kernels of {SUPERSTEP} steps: {graph}")
    _profile(tr, "tensorf")

    # tensorf_sample and its backward at the step's own k0 points, beside the dense 12-channel lookup
    seen, sample = [], tensorf.tensorf_sample
    tensorf.tensorf_sample = lambda params, xyz, lo, hi: seen.append((xyz.detach().reshape(-1, 3).clone(), lo, hi)) \
        or sample(params, xyz, lo, hi)
    try:
        tr.step()
    finally:
        tensorf.tensorf_sample = sample
    pts, lo, hi = seen[0]
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in tr.obj_params["k0_grid"].items()}
    g = torch.Generator(device=DEVICE).manual_seed(300)
    ct = torch.randn((pts.shape[0], om.rgbnet_dim), generator=g, device=DEVICE)
    dense = tensorf.tensorf_to_dense({k: v.detach() for k, v in leaves.items()}).contiguous().requires_grad_(True)

    def tf_fwd_bwd():
        torch.autograd.grad(tensorf.tensorf_sample(leaves, pts, lo, hi), list(leaves.values()), ct)

    def dense_fwd_bwd():
        torch.autograd.grad(grid_ops.trilinear_sample(dense, pts, lo, hi), [dense], ct)

    with torch.no_grad():
        tf_fwd = _device_ms(lambda: tensorf.tensorf_sample(leaves, pts, lo, hi))
        dense_fwd = _device_ms(lambda: grid_ops.trilinear_sample(dense, pts, lo, hi))
        err = float((tensorf.tensorf_sample(leaves, pts, lo, hi) - grid_ops.trilinear_sample(dense, pts, lo, hi)).abs().max())
    tf_both, dense_both = _device_ms(tf_fwd_bwd), _device_ms(dense_fwd_bwd)
    print(f"tensorf_sample at the step's {pts.shape[0]} k0 points (device time): forward {tf_fwd:.4f} ms, forward + "
          f"backward {tf_both:.4f} ms; the dense 12-channel lookup of tensorf_to_dense(k0) {tuple(dense.shape)} at the "
          f"same points: forward {dense_fwd:.4f} ms, forward + backward {dense_both:.4f} ms; max abs diff of the two "
          f"{err:.2e}")
    if not err <= 1e-4:
        raise AssertionError("tensorf_sample disagrees with the lookup of its dense expansion")

    # one doubling through tensorf_resize: the next window captures the step again
    before = tr._graphs.graph
    t0 = time.perf_counter()
    tr.scale_volume_grid(om.num_voxels * 2)
    tr.refresh_maskcache()
    torch.cuda.synchronize()
    resize_s = time.perf_counter() - t0
    reset()
    window = tr.steps_scan(SUPERSTEP)
    torch.cuda.synchronize()
    doubled = counts()
    losses = [float(x) for x in window["loss_total"]]
    k0 = tr.obj_params["k0_grid"]
    print(f"tensorf doubling to {tr.cfg.object_model.world_size} in {resize_s:.3f} s (tensorf_resize: "
          + ", ".join(f"{k} {tuple(v.shape)}" for k, v in k0.items()) + f"); the next window captured again "
          f"(capture {tr._graphs.graph.capture_s:.3f} s): losses {losses}, launches {doubled}")
    if not (tr._graphs.graph is not before and tr._graphs.graph is not None and all(map(math.isfinite, losses))
            and tuple(k0["xy_plane"].shape[1:]) == tr.cfg.object_model.world_size[:2]
            and doubled == {k: v * SUPERSTEP for k, v in per_step.items()}):
        raise AssertionError("the window after the doubling did not capture again or launch the step's kernels")

    # a checkpoint written and read back bit for bit
    path = os.path.join(work, "tensorf.npz")
    t0 = time.perf_counter()
    state_mod.save_checkpoint(path, tr, extras=tr.host_extras())
    write_s = time.perf_counter() - t0
    back = trainer_mod.JointTrainer(cfg, data, device=DEVICE)
    t0 = time.perf_counter()
    state_mod.restore_state(back, state_mod.load_checkpoint(path))
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    same = all(torch.equal(a, b) for a, b in zip(tr.state_tensors(), back.state_tensors()))
    print(f"tensorf checkpoint: {os.path.getsize(path)} bytes written in {write_s:.3f} s, read into a fresh trainer "
          f"in {read_s:.3f} s; {len(tr.state_tensors())} state tensors bit for bit: {same}; grid "
          f"{back.cfg.object_model.world_size}, {len(tree_leaves(back.obj_params['k0_grid']))} k0 leaves")
    if not (same and back.cfg.object_model.world_size == tr.cfg.object_model.world_size
            and len(tr.state_tensors()) == len(back.state_tensors())):
        raise AssertionError("the TensoRF checkpoint did not read back bit for bit")
    return {"tensorf": eager, "tensorf_graph": graph, "tensorf_doubled": doubled}, errs


def drive_fresh_dc(mods: dict, trainer_mod) -> tuple[dict, dict]:
    """`build_scene_trainer()` at step 18,001 with the `corres` weight removed:
    depth consistency renders its reference depth at fresh pixels. Eager
    steps (the trunk launches counted), the trunk kernels held at the step's
    calls, one step against the plain trunk, and a graph window against eager
    steps."""
    fused_mlp, grid_ops = mods["fused_mlp"], mods["grid"]
    counts, reset = _launch_counters(fused_mlp, grid_ops)
    cfg, data = trainer_mod._bench_workload(SMALL, "bfloat16")
    lw = tuple((k, None if k == "corres" else v) for k, v in cfg.scene_train.loss_weight)
    cfg = dataclasses.replace(cfg, scene_train=dataclasses.replace(cfg.scene_train, loss_weight=lw))
    tr = trainer_mod.SceneTrainer(cfg, data, device=DEVICE)
    sm = tr.cfg.scene_model
    tr.global_step = tr.fine_start + 1
    flags = tr.phase_flags(tr.global_step)
    if not (flags["fine_on"] and flags["depth_cons_on"] and "dc_pixels" in tr.sample_draws(flags)):
        raise AssertionError(f"step {tr.global_step} does not take depth consistency from fresh pixels: {flags}")
    start = tr.global_step
    ms, eager, metrics = _eager_steps(tr, 4, counts, reset)
    per_step = {k: v / 4 for k, v in eager.items()}
    n_ref = max(256, sm.rand_rays)
    print(f"fresh-pixel mid step {start} (corres off; {n_ref} fresh reference pixels, {sm.rand_rays} rays, "
          f"{sm.sample_intvs}+{sm.sample_intvs_fine} samples): eager {ms:.2f} ms/step, loss "
          f"{float(metrics[0]['loss_total']):.5f} -> {float(metrics[-1]['loss_total']):.5f}; launches per step "
          f"{per_step}")
    # per step: the main, reference and unseen-pose renders coarse + fine and the visibility render coarse +
    # fine (8 forwards); backwards for all but the visibility render's two and the reference's coarse pass,
    # whose depth the loss does not read (5)
    if per_step != {"trunk_fwd": 8, "trunk_bwd": 5, "trilinear_fwd": 0, "trilinear_bwd": 0}:
        raise AssertionError(f"the fresh-pixel step did not launch the trunk kernels of its renders: {per_step}")
    calls = []
    with _capturing(fused_mlp, grid_ops, calls, []):
        tr.step()
    torch.cuda.synchronize()
    errs = _hold_captured(fused_mlp, grid_ops, [], calls, "fresh_dc", lookup_bwd=False)
    _, rel = _loss_against_plain(
        tr, lambda f, d: tr.loss(tr.scene_params, tr.pose_params, tr.global_step, f, d)[0], grid_ops)
    print(f"fresh-pixel step loss through the trunk kernels against the plain trunk: rel diff {rel:.2e} "
          f"(tolerance {REL_TOL})")
    if not rel <= REL_TOL:
        raise AssertionError("the fresh-pixel step's loss through the kernels disagrees with the plain trunk's")
    graph = check_superstep(tr, "fresh_dc", counts, reset)
    if graph != {k: v * SUPERSTEP for k, v in per_step.items()}:
        raise AssertionError(f"the fresh-pixel graph window did not launch the trunk kernels of {SUPERSTEP} steps: "
                             f"{graph}")
    _profile(tr, "fresh_dc")
    return {"fresh_dc": eager, "fresh_dc_graph": graph}, {k: v for k, v in errs.items() if k.startswith("trunk")}


def drive_superglue(mods: dict, trainer_mod, work: str, root: str, preset: tuple) -> dict:
    """SuperPoint + SuperGlue on `drive_preset`'s 1600x1200 scan with seeded
    random weights (`tools/superglue_weights.py`, written through the port's
    `convert.save_npz`): `load_dtu` with the SuperGlue backend on the card,
    the matching timed again alone, the device time of SuperPoint per image
    and SuperGlue per pair, the card's heat map, descriptor map and log
    assignment against the same modules on the CPU, then a `JointTrainer`
    from the SuperGlue packs (the PnP chain) and `fit(SG_FIT_STEPS)` in
    graph windows."""
    from poseprobe_tpu_torch.data import loaders
    from poseprobe_tpu_torch.pose_init import matching, superglue
    from tools.superglue_weights import write
    fused_mlp, grid_ops = mods["fused_mlp"], mods["grid"]
    counts, reset = _launch_counters(fused_mlp, grid_ops)
    cfg = preset[0]
    wdir = os.path.join(work, "superglue_weights")
    write(wdir)
    os.environ[matching.SUPERGLUE_WEIGHTS_ENV] = wdir
    t0 = time.perf_counter()
    data = loaders.load_dtu(cfg.data, matcher_backend="superglue", matcher_device=DEVICE)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    matching.build_match_packs(data.images, data.masks, data.i_train, data.pair_j, max_matcher=cfg.data.max_matcher,
                               backend="superglue", device=DEVICE)
    match_s = time.perf_counter() - t0
    n_pairs = 2 * len(data.i_train)
    packs = {k: [int(n) for n in (getattr(data, k)[..., 4] > 0).sum(axis=1)]
             for k in ("obj_matches", "scene_matches", "ba_matches")}
    sp, sg = superglue.load_networks(DEVICE)
    H, W = data.H, data.W
    gray = [torch.as_tensor(matching._grayscale_u8(data.images[i]), device=DEVICE).float() / 255.0 for i in (1, 0)]
    with torch.no_grad():
        sp_ms = _device_ms(lambda: sp(gray[0]), iters=5)
        (k0, s0, d0), (k1, s1, d1) = sp(gray[0]), sp(gray[1])
        sg_ms = _device_ms(lambda: sg(k0, s0, d0, k1, s1, d1, (H, W)), iters=5)
        # the card against the CPU: the SuperPoint maps, and the log assignment at the card's keypoints
        sp_cpu, sg_cpu = superglue.load_networks("cpu")
        heat, desc_map = sp.maps(gray[0])
        heat_c, desc_c = sp_cpu.maps(gray[0].cpu())
        Z = sg.log_assignment(k0, s0, d0, k1, s1, d1, (H, W))
        Z_c = sg_cpu.log_assignment(*[t.cpu() for t in (k0, s0, d0, k1, s1, d1)], (H, W))
    heat_rel = float((heat.cpu() - heat_c).abs().max() / heat_c.abs().max())
    desc_rel = float((desc_map.cpu() - desc_c).abs().max() / desc_c.abs().max())
    z_abs = float((Z.cpu() - Z_c).abs().max())
    print(f"superglue on the {H}x{W} scan (seeded random weights): load_dtu with matching {load_s:.2f} s; "
          f"build_match_packs again alone {match_s:.2f} s for {n_pairs} pairs; matches per pack {packs}; device time "
          f"SuperPoint {sp_ms:.3f} ms per image ({int((s0 > 0).sum())} of {k0.shape[0]} keypoints scored), "
          f"SuperGlue {sg_ms:.3f} ms per pair ({k0.shape[0]}x{k1.shape[0]}, 20 Sinkhorn iterations); card against "
          f"CPU: heat map max abs err {heat_rel:.2e} of max, descriptor map {desc_rel:.2e} of max, log assignment "
          f"max abs err {z_abs:.2e} (tolerance {SG_REL_TOL})")
    if not (heat_rel <= SG_REL_TOL and desc_rel <= SG_REL_TOL and z_abs <= SG_REL_TOL):
        raise AssertionError("SuperPoint / SuperGlue on the card disagree with the CPU")
    _require_matches(packs, "load_dtu's SuperGlue packs")
    t0 = time.perf_counter()
    tr = trainer_mod.JointTrainer(cfg, data, device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    reset()
    t0 = time.perf_counter()
    hist = tr.fit(SG_FIT_STEPS, log_every=SUPERSTEP, superstep=SUPERSTEP)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit = counts()
    print(f"superglue trainer (dtu_generic, the PnP chain on the SuperGlue packs) built in {build_s:.2f} s; "
          f"fit({SG_FIT_STEPS}, superstep={SUPERSTEP}) {fit_s:.2f} s: losses {[round(h['loss_total'], 5) for h in hist]}, "
          f"launches {fit}")
    if not (len(hist) == SG_FIT_STEPS // SUPERSTEP and all(math.isfinite(h["loss_total"]) for h in hist)
            and min(fit.values()) >= SG_FIT_STEPS):
        raise AssertionError("the trainer on the SuperGlue packs did not fit through the kernels")
    return {"superglue_fit": fit}


def _require_matches(packs: dict, what: str) -> None:
    """Every pair's pack holds matches at the published 0.2 threshold, so that
    what follows fits on SuperGlue's matches and not on empty packs."""
    if not all(n > 0 for v in packs.values() for n in v):
        raise AssertionError(f"{what}: a pair has no match above the threshold: {packs}")


def drive_tensorf_cli(mods: dict, work: str) -> dict:
    """`run --synthetic --grid_type tensorf --match_source superglue --matcher
    superglue` for a few steps at full width with one test view, then
    `evaluate --eval_mesh` on its last checkpoint. The synthetic scene the run
    builds is read back to check its SuperGlue packs."""
    from poseprobe_tpu_torch import evaluate as evaluate_cli, run as run_cli
    from poseprobe_tpu_torch.data import synthetic
    fused_mlp, grid_ops = mods["fused_mlp"], mods["grid"]
    counts, reset = _launch_counters(fused_mlp, grid_ops)
    cwd = os.path.join(work, "cli_tensorf")
    os.makedirs(cwd)
    old, make_scene = os.getcwd(), synthetic.make_synthetic_scene
    scenes = []
    synthetic.make_synthetic_scene = lambda **kw: scenes.append(make_scene(**kw)) or scenes[-1]
    os.chdir(cwd)
    try:
        torch.cuda.synchronize()
        reset()
        t0 = time.perf_counter()
        run_cli.main(CLI13_FLAGS)
        torch.cuda.synchronize()
        run_s, run_counts = time.perf_counter() - t0, counts()
        ckpt = os.path.join(cwd, "logs", "synthetic", "last_ckpt.pkl")
        with open(os.path.join(cwd, "logs", "synthetic", "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        reset()
        t0 = time.perf_counter()
        evaluate_cli.main(["--synthetic", "--n_test", "1", "--ckpt", ckpt, "--eval_mesh"])
        torch.cuda.synchronize()
        eval_s, eval_counts = time.perf_counter() - t0, counts()
        with open(os.path.join(cwd, "logs", "synthetic", "eval", "synthetic.json")) as f:
            ev = json.load(f)
    finally:
        os.chdir(old)
        synthetic.make_synthetic_scene = make_scene
    packs = {k: [int(n) for n in (getattr(scenes[0], k)[..., 4] > 0).sum(axis=1)]
             for k in ("obj_matches", "scene_matches", "ba_matches")}
    print(f"cli tensorf + superglue: the synthetic scene's SuperGlue matches per pack {packs}")
    _require_matches(packs, "the CLI's synthetic SuperGlue packs")
    print(f"cli tensorf + superglue: run {run_s:.2f} s ({[r['step'] for r in rows]} logged, losses "
          f"{[round(r['loss_total'], 5) for r in rows]}), launches {run_counts}; evaluate --eval_mesh {eval_s:.2f} s, "
          f"launches {eval_counts}; psnr with test-time optimization {ev['w_test_optim']['psnr']:.3f}")
    # the synthetic config's scene trunk is float32 (the reference's), which the fused trunk does not take:
    # the lookups carry this path
    if not (rows and rows[-1]["step"] == 8 and all(math.isfinite(r["loss_total"]) for r in rows)
            and ev["iteration"] == 8 and run_counts["trilinear_fwd"] > 0 and run_counts["trilinear_bwd"] > 0
            and eval_counts["trilinear_fwd"] > 0):
        raise AssertionError("the TensoRF + SuperGlue CLI run or its evaluation did not run through the kernels")
    return {"cli_tensorf": run_counts, "cli_tensorf_eval": eval_counts}


def drive_last_paths(mods: dict, trainer_mod, work: str, root: str, preset: tuple) -> tuple[dict, dict]:
    """The last single-card paths, after the CLI phase: TensoRF, depth
    consistency from fresh pixels, SuperGlue, and the CLI over TensoRF and
    SuperGlue. Returns the launches by part and the kernel checks' worst
    errors."""
    counts, errs, secs = {}, {}, {}
    parts = {"tensorf": lambda: drive_tensorf(mods, trainer_mod, work),
             "fresh_dc": lambda: drive_fresh_dc(mods, trainer_mod),
             "superglue": lambda: (drive_superglue(mods, trainer_mod, work, root, preset), {}),
             "cli": lambda: (drive_tensorf_cli(mods, work), {})}
    for name, part in parts.items():
        t0 = time.perf_counter()
        c, e = part()
        secs[name] = round(time.perf_counter() - t0, 1)
        counts.update(c)
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)
    print(f"last paths' phase, seconds by part: {secs}")
    return counts, errs


# ------------------------------------------------------------------ parallel

PARALLEL_RANKS = 2
NCCL_WINDOWS = 2                       # the captured window, then one replay of it
PARALLEL_DEADLINE_S = 420              # a hung collective fails the phase instead of stalling the run
TP_STEP = dict(near=1.0, far=3.5, n_samples=96, xyz_min=(-0.5,) * 3, xyz_max=(0.5,) * 3, s_val=0.05)
TP_GRID, TP_RAYS, TP_VIEWS = 192, 1024, 2   # benchmarks/grid_tp_step.py's defaults (96 samples above)
TP_VALUE_ATOL = 2e-5                   # the sharded sampler's rebased z coordinate (tests/test_grid_tp.py)


def _param_copies(tr) -> dict:
    """The params and the Adam first moments (which carry the gradients: a
    gradient off by a factor moves them by that factor, where Adam's step
    hardly moves), copied to the host."""
    from poseprobe_tpu_torch.core.tree import tree_leaves
    out = {}
    for n in tr.GROUPS:
        state = getattr(tr, f"opt_{n}_state")
        for what, tree in (("", getattr(tr, f"{n}_params")), (" mu", None if state is None else state["mu"])):
            out.update({f"{n}{what}[{i}]": t.detach().cpu().clone() for i, t in enumerate(tree_leaves(tree))
                        if tree is not None})
    return out


def _rel_l2(a: dict, b: dict) -> tuple[float, str]:
    """The worst difference between two `_param_copies`, in the L2 norm: an
    Adam first moment relative to its own norm (the moments carry the
    gradients), a param relative to the norm of its group's params (a
    zero-initialised bias takes its first Adam steps of +-lr each, whose sign
    the kernels' atomics decide for a gradient element near zero, so its own
    norm does not bound it)."""
    sq: dict = {}
    for k, t in b.items():
        sq[k.split("[")[0]] = sq.get(k.split("[")[0], 0.0) + float(t.float().norm()) ** 2
    return max((float((a[k] - b[k]).float().norm())
                / max(float(b[k].float().norm()) if " mu[" in k else sq[k.split("[")[0]] ** 0.5, 1e-30), k)
               for k in b)


def _dp_sequence(tr, capture=contextlib.nullcontext, timed_steps: int = 5) -> dict:
    """The data-parallel phase's steps, run alike on the ranks and on one
    rank: an early step from step 1 and a mid step (fine sampling, depth
    consistency) on the draws of a fresh trainer, each inside `capture()`,
    the params after each, then eager early-phase steps timed."""
    out = {}
    for phase, step in (("early", 1), ("mid", tr.fine_start + 1)):
        tr.global_step = step
        with capture():
            out[f"{phase}_loss"] = float(tr.step()["loss_total"])
        out[f"{phase}_params"] = _param_copies(tr)
    tr.global_step = 2
    tr.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed_steps):
        tr.step()
    torch.cuda.synchronize()
    out["step_ms"] = (time.perf_counter() - t0) / timed_steps * 1e3
    return out


def _tp_inputs(device, sm) -> tuple:
    """benchmarks/grid_tp_step.py's inputs from a seed (a cube SDF and a
    12-channel k0 at 192^3, 1024 rays from z = -2 into the box, targets), and
    the joint step's (the rays as two views' camera rays, base poses, se3
    deltas, the scene params of `sm`)."""
    from poseprobe_tpu_torch.models import scene_nerf
    g = torch.Generator().manual_seed(0)
    xs = torch.linspace(-0.5, 0.5, TP_GRID)
    X, Y, Z = torch.meshgrid(xs, xs, xs, indexing="ij")
    sdf = (torch.maximum(torch.maximum(X.abs(), Y.abs()), Z.abs()) - 0.3)[None]
    k0 = torch.randn((12, TP_GRID, TP_GRID, TP_GRID), generator=g) * 0.05
    ang = torch.rand((TP_RAYS, 2), generator=g) * 0.5 - 0.25
    rays_d = torch.stack([torch.tan(ang[:, 0]), torch.tan(ang[:, 1]), torch.ones(TP_RAYS)], -1)
    rays_o = torch.tensor([0.0, 0.0, -2.0]).expand(TP_RAYS, 3).contiguous()
    tgt, msk = torch.rand((TP_RAYS, 3), generator=g), (ang.abs() < 0.15).all(1).float()
    base = torch.eye(3, 4).repeat(TP_VIEWS, 1, 1)
    base[:, 2, 3], base[:, 0, 3] = 2.0, torch.linspace(-0.1, 0.1, TP_VIEWS)
    joint = {"params": {"sdf": sdf, "k0": k0, "se3": torch.randn((TP_VIEWS, 6), generator=g) * 0.01,
                        "scene": scene_nerf.init_scene_params(torch.Generator().manual_seed(3), sm, "cpu")},
             "rays_cam": rays_d.reshape(TP_VIEWS, -1, 3), "base_w2c": base,
             "targets": tgt.reshape(TP_VIEWS, -1, 3), "masks": msk.reshape(TP_VIEWS, -1)}
    to = lambda t: t.to(device)  # noqa: E731
    from poseprobe_tpu_torch.core.tree import tree_map
    return [to(t) for t in (sdf, k0, rays_o, rays_d, tgt, msk)], tree_map(to, joint)


def _tp_compare(label: str, loss, ref_loss, pairs: dict) -> dict:
    """A sharded step's loss and updates against the unsharded step's: the
    loss within GRAPH_LOSS_RTOL, each update {name: (this rank's, its part of
    the reference's, the whole reference's)} within REL_TOL of the whole
    reference update in the L2 norm (a slab behind the surface takes updates
    near zero, which a norm of their own would not bound)."""
    loss_rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    rel = max((float((a - b).norm()) / max(float(w.norm()), 1e-30), k) for k, (a, b, w) in pairs.items())
    if not (loss_rel <= GRAPH_LOSS_RTOL and rel[0] <= REL_TOL):
        raise AssertionError(f"{label}: loss rel {loss_rel:.2e}, worst rel L2 {rel}")
    return {"loss_rel": loss_rel, "rel_l2": rel[0], "worst": rel[1]}


def _timed(fn, n: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def _parallel_rank(rank: int, world: int, work: str, backend: str) -> None:
    """One rank of the parallel phase (a spawned process): the data-parallel
    steps of `build_trainer()` and a `fit` window across a view activation on
    a ('data',) mesh; `train_step_tp` and `joint_step_tp` on a (1, world)
    mesh against the unsharded steps on this card; then the trunk and
    trilinear kernels held against their plain versions at every call of the
    early and mid DP steps and of the `joint_step_tp` call (this rank's share
    of the rays, the halo-extended slabs). Writes its results to
    ``work/rank<rank>.pt``."""
    import torch.distributed as dist
    from poseprobe_tpu_torch.core.tree import tree_leaves
    from poseprobe_tpu_torch.ops import fused_mlp, grid as grid_ops
    from poseprobe_tpu_torch.parallel import grid_tp, mesh as mesh_mod, multihost, object_tp
    from poseprobe_tpu_torch.train import trainer as trainer_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    multihost.init_distributed(f"file://{work}/rendezvous", world, rank, backend=backend,
                               timeout_s=PARALLEL_DEADLINE_S)
    mesh = mesh_mod.make_mesh()
    dev = mesh.device
    counts, reset = _launch_counters(fused_mlp, grid_ops)
    out = {"device": str(dev), "backend": mesh.backend}
    reset()
    tr = trainer_mod.build_trainer(small=SMALL, device=dev, mesh=mesh)
    dp_calls, dp_lookups, tp_calls, tp_lookups = [], [], [], []
    out["dp"] = _dp_sequence(tr, lambda: _capturing(fused_mlp, grid_ops, dp_calls, dp_lookups))
    tr.global_step = tr.cfg.camera.incremental_step - 2          # a window, the activation of view 3, a window
    n_active = tr.n_active
    out["fit_hist"] = tr.fit(4, log_every=2, superstep=2)
    out["fit_params"] = _param_copies(tr)
    out["fit_n_active"] = (n_active, tr.n_active)
    flat = torch.zeros(sum(t.numel() for n in tr._trained(tr.phase_flags(1)) for t in tree_leaves(
        getattr(tr, f"{n}_params"))), device=dev)
    sm = tr.cfg.scene_model
    del tr

    tp_mesh = grid_tp.make_grid_mesh(1, world)
    (sdf, k0, ro, rd, tgt, msk), joint = _tp_inputs(dev, sm)
    slabs = [grid_tp.shard_grid(g, tp_mesh) for g in (sdf, k0)]
    new_sdf, new_k0, m = object_tp.train_step_tp(*slabs, ro, rd, tgt, msk, mesh=tp_mesh, **TP_STEP)
    jp = dict(joint["params"], sdf=grid_tp.shard_grid(joint["params"]["sdf"], tp_mesh),
              k0=grid_tp.shard_grid(joint["params"]["k0"], tp_mesh))
    jargs = {k: v for k, v in joint.items() if k != "params"}
    with _capturing(fused_mlp, grid_ops, tp_calls, tp_lookups):
        jnew, jm = object_tp.joint_step_tp(jp, sm, **jargs, progress=1.0, mesh=tp_mesh, **TP_STEP)
    torch.cuda.synchronize()
    out["counts"] = counts()                                     # the main path's launches end here

    s, G = tp_mesh.axis(grid_tp.GRID_AXIS).index, world
    cut = lambda t: t[..., s * (TP_GRID // G):(s + 1) * (TP_GRID // G)]  # noqa: E731
    ref_sdf, ref_k0, ref_m = object_tp.train_step_tp(sdf, k0, ro, rd, tgt, msk, mesh=None, **TP_STEP)
    # the updates (SGD: lr x the gradient) of this rank's slabs against the unsharded step's
    out["tp"] = _tp_compare(f"rank {rank} train_step_tp", m["loss"], ref_m["loss"],
                            {"sdf": (new_sdf - slabs[0], cut(ref_sdf - sdf), ref_sdf - sdf),
                             "k0": (new_k0 - slabs[1], cut(ref_k0 - k0), ref_k0 - k0)})
    ref_new, ref_jm = object_tp.joint_step_tp(joint["params"], sm, **jargs, progress=1.0, mesh=None, **TP_STEP)
    leaves = zip(*(tree_leaves(t) for t in (jp, jnew, joint["params"], ref_new)))
    pairs = {f"param[{i}] {tuple(w.shape)}": (n - o, (r - w) if o.shape == w.shape else cut(r - w), r - w)
             for i, (o, n, w, r) in enumerate(leaves)}
    out["joint"] = _tp_compare(f"rank {rank} joint_step_tp", jm["loss"], ref_jm["loss"], pairs)

    t = torch.linspace(TP_STEP["near"], TP_STEP["far"], TP_STEP["n_samples"], device=dev)
    pts = (ro[:, None] + rd[:, None] * t[None, :, None]).reshape(-1, 3)
    lo, hi = (torch.tensor(b, device=dev) for b in (TP_STEP["xyz_min"], TP_STEP["xyz_max"]))
    sharded = grid_tp.sample_grid_tp(slabs[1], pts, lo, hi, tp_mesh)
    out["value_err"] = float((sharded - grid_ops.trilinear_sample(k0, pts, lo, hi)).abs().max())
    if not out["value_err"] <= TP_VALUE_ATOL:
        raise AssertionError(f"rank {rank}: sharded lookup off by {out['value_err']:.3e}")

    # times: the sharded step with its collectives, the unsharded step on this card with the
    # other ranks waiting, the halo exchange, and the data-parallel gradient all-reduce
    out["tp_ms"] = _timed(lambda: object_tp.train_step_tp(*slabs, ro, rd, tgt, msk, mesh=tp_mesh, **TP_STEP))
    out["joint_ms"] = _timed(lambda: object_tp.joint_step_tp(jp, sm, **jargs, progress=1.0, mesh=tp_mesh,
                                                             **TP_STEP))
    out["halo_ms"] = _timed(lambda: grid_tp._halo_extend(slabs[1], tp_mesh), n=10)
    out["halo_bytes"] = world * slabs[1][..., 0].numel() * 4
    if rank == 0:
        out["tp_alone_ms"] = _timed(lambda: object_tp.train_step_tp(sdf, k0, ro, rd, tgt, msk, mesh=None, **TP_STEP))
    dist.barrier()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    mesh.all_reduce_(flat, mesh.axis(mesh_mod.DATA_AXIS))
    start.record()
    for _ in range(5):
        mesh.all_reduce_(flat, mesh.axis(mesh_mod.DATA_AXIS))
    end.record()
    torch.cuda.synchronize()
    out["all_reduce_ms"], out["all_reduce_bytes"] = start.elapsed_time(end) / 5, flat.numel() * 4

    # the kernels against their plain versions at the main path's own calls on this rank
    out["shapes"] = {"dp_trunk_points": sorted({c[0].shape[0] for c in dp_calls}),
                     "tp_trunk_points": sorted({c[0].shape[0] for c in tp_calls}),
                     "tp_grids": sorted({gs for gs, *_ in tp_lookups})}
    dp_errs = _hold_captured(fused_mlp, grid_ops, dp_lookups, dp_calls, f"rank {rank} DP steps", lookup_bwd=True)
    del dp_calls, dp_lookups
    tp_errs = _hold_captured(fused_mlp, grid_ops, tp_lookups, tp_calls, f"rank {rank} joint_step_tp",
                             lookup_bwd=True)
    out["errs"] = {k: max(dp_errs[k], tp_errs[k]) for k in dp_errs}
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _nccl_rank(work: str) -> None:
    """The captured step with its all-reduce inside the graph: two windows of
    `fit(superstep=4)` of `build_trainer()` from step 0 on an NCCL group of
    one rank (the capture, then a replay), against the same windows without
    a mesh, run twice; the params after each window (a spawned process).
    The runs without a mesh start their second window from the mesh run's
    state after its first (`_copy_state`: in place, so that their captured
    steps stay valid; their host state held equal to the mesh run's first),
    so that a window parts the runs only by its own atomics, as the first
    does. Writes ``work/nccl.pt``."""
    import datetime
    import torch.distributed as dist
    from poseprobe_tpu_torch.ops import fused_mlp, grid as grid_ops
    from poseprobe_tpu_torch.parallel import mesh as mesh_mod
    from poseprobe_tpu_torch.train import trainer as trainer_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    # init_distributed takes a job of one rank for none; the group is made here
    dist.init_process_group("nccl", init_method=f"file://{work}/rendezvous_nccl", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=PARALLEL_DEADLINE_S))
    mesh = mesh_mod.make_mesh()
    counts, reset = _launch_counters(fused_mlp, grid_ops)
    out, starts = {}, []
    for name in ("mesh", "alone", "rerun"):
        t = trainer_mod.build_trainer(small=SMALL, device="cuda", mesh=mesh if name == "mesh" else None)
        t.global_step = 0
        if name == "mesh":
            reset()
            issued = mesh.all_reduces
        torch.cuda.synchronize()
        params = []
        for w in range(NCCL_WINDOWS):
            if w and name == "mesh":
                starts.append(([x.clone() for x in t.state_tensors()], _host_state(t)))
            elif w:
                _copy_state(t, *starts[w - 1], f"NCCL {name} before window {w + 1}")
            hist = t.fit(SUPERSTEP, log_every=SUPERSTEP, superstep=SUPERSTEP)
            params.append(_param_copies(t))
        out[name] = {"hist": hist, "params": params}
        if name == "mesh":
            out["counts"] = counts()
            out["issued"] = mesh.all_reduces - issued
            out["captured"] = t._graphs.graph is not None
        out[name]["replay_ms"] = _timed(lambda: t.steps_scan(SUPERSTEP), n=2) / SUPERSTEP
        t.drop_graphs()
        del t
        torch.cuda.empty_cache()
    torch.save(out, os.path.join(work, "nccl.pt"))
    dist.destroy_process_group()


def _spawn(target, arglists: list, what: str) -> None:
    """Run `target` in one spawned process per argument list; all must end
    with code 0 before PARALLEL_DEADLINE_S, else every one left is ended and
    the phase fails."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=args) for args in arglists]
    for p in procs:
        p.start()
    deadline = time.monotonic() + PARALLEL_DEADLINE_S
    try:
        while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(30)
    codes = [p.exitcode for p in procs]
    if codes != [0] * len(procs):
        raise AssertionError(f"{what}: exit codes {codes} (None or negative: ended at the "
                             f"{PARALLEL_DEADLINE_S} s deadline or by a signal)")


def drive_parallel(trainer_mod, smi: str) -> tuple[dict, dict]:
    """The parallel package on the card. Two ranks (NCCL with one per card
    where there are two cards, else gloo, both on cuda:0): the data-parallel
    early and mid steps of `build_trainer()` at full width against the same
    steps on one rank (this process), the two ranks' params bit for bit
    equal, a `fit` window across a view activation; `train_step_tp` at 192^3
    and `joint_step_tp` with the bf16 trunk on a (1, 2) mesh against the
    unsharded steps. Then one NCCL rank: `fit(superstep=4)`, its step captured
    with the gradient all-reduce inside the graph, against the same `fit`
    without a mesh. Returns the ranks' launches (summed) and the kernel
    checks' worst errors."""
    n_cards = torch.cuda.device_count()
    backend = "nccl" if n_cards >= PARALLEL_RANKS else "gloo"
    print(f"parallel phase: {PARALLEL_RANKS} ranks, backend {backend} ({n_cards} card(s); "
          f"{'one rank per card' if backend == 'nccl' else 'both ranks on cuda:0'})")
    work = tempfile.mkdtemp(prefix="poseprobe_parallel_")
    try:
        t0 = time.perf_counter()
        ref_tr = trainer_mod.build_trainer(small=SMALL, device=DEVICE)
        ref = _dp_sequence(ref_tr)
        del ref_tr
        torch.cuda.empty_cache()
        _spawn(_parallel_rank, [(r, PARALLEL_RANKS, work, backend) for r in range(PARALLEL_RANKS)],
               f"{PARALLEL_RANKS} {backend} ranks")
        ranks_s = time.perf_counter() - t0
        res = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False) for r in range(PARALLEL_RANKS)]
        t0 = time.perf_counter()
        _spawn(_nccl_rank, [(work,)], "one NCCL rank")
        nccl_s = time.perf_counter() - t0
        nccl = torch.load(os.path.join(work, "nccl.pt"), weights_only=False)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    for phase in ("early", "mid", "fit"):
        key = "fit_params" if phase == "fit" else f"{phase}_params"
        a, b = (r[key] if phase == "fit" else r["dp"][key] for r in res[:2])
        if not all(torch.equal(a[k], b[k]) for k in a):
            raise AssertionError(f"parallel {phase}: the ranks' params differ")
    for phase in ("early", "mid"):
        loss_rel = abs(res[0]["dp"][f"{phase}_loss"] - ref[f"{phase}_loss"]) / abs(ref[f"{phase}_loss"])
        rel = _rel_l2(res[0]["dp"][f"{phase}_params"], ref[f"{phase}_params"])
        print(f"DP {phase} step on {PARALLEL_RANKS} ranks against 1: loss {res[0]['dp'][f'{phase}_loss']:.6f} "
              f"against {ref[f'{phase}_loss']:.6f} (rel {loss_rel:.2e}, tolerance {GRAPH_LOSS_RTOL}); params rel L2 "
              f"{rel[0]:.2e} (tolerance {REL_TOL}, worst {rel[1]}); the ranks' params bit for bit equal")
        if not (loss_rel <= GRAPH_LOSS_RTOL and rel[0] <= REL_TOL):
            raise AssertionError(f"parallel {phase}: the data-parallel step disagrees with one rank")
    hist, (before, after) = res[0]["fit_hist"], res[0]["fit_n_active"]
    graph = backend == "nccl"
    if not (after == before + 1 and all(h["graph"] is graph and math.isfinite(h["loss_total"]) for h in hist)):
        raise AssertionError(f"parallel fit: n_active {before} -> {after}, history {hist}")
    print(f"DP fit(4, superstep=2) across the activation of view {after}: windows at steps "
          f"{[h['step'] for h in hist]}, graph {graph} ({backend}: "
          f"{'captured' if graph else 'gloo cannot be captured, the windows run eagerly'}), losses "
          f"{[round(h['loss_total'], 6) for h in hist]}; the ranks' params bit for bit equal after it")
    for r, x in enumerate(res):
        print(f"rank {r} ({x['device']}, {x['backend']}): train_step_tp 192^3 against unsharded: loss rel "
              f"{x['tp']['loss_rel']:.2e}, grids rel L2 {x['tp']['rel_l2']:.2e}; joint_step_tp: loss rel "
              f"{x['joint']['loss_rel']:.2e}, worst rel L2 {x['joint']['rel_l2']:.2e} ({x['joint']['worst']}); "
              f"sharded lookup max abs err {x['value_err']:.2e} (tolerance {TP_VALUE_ATOL})")
    x = res[0]
    print(f"[{smi}] DP eager step (early phase, build_trainer() full width): {x['dp']['step_ms']:.2f} ms on "
          f"{PARALLEL_RANKS} ranks ({backend}), {ref['step_ms']:.2f} ms on 1; gradient all-reduce "
          f"{x['all_reduce_ms']:.3f} ms (CUDA events on the rank's stream) for {x['all_reduce_bytes'] / 1e6:.1f} MB")
    print(f"[{smi}] TP (1, {PARALLEL_RANKS}) train_step_tp at 192^3, 1024 rays x 96 samples: {x['tp_ms']:.2f} ms "
          f"(unsharded on the card alone {x['tp_alone_ms']:.2f} ms); joint_step_tp {x['joint_ms']:.2f} ms; halo "
          f"exchange of the 12-channel slab {x['halo_ms']:.3f} ms ({x['halo_bytes'] / 1e6:.2f} MB slot buffer)")

    # the grids' first Adam steps are +-lr (0.1) wherever the atomics flip a near-zero gradient's
    # sign, so two runs without a mesh give the spread the mesh run is held to, window by window;
    # every window starts all three runs from one state (`_nccl_rank`)
    def diff(x, y, w):
        a, b = nccl[x]["hist"][w]["loss_total"], nccl[y]["hist"][w]["loss_total"]
        return abs(a - b) / abs(b), _rel_l2(nccl[x]["params"][w], nccl[y]["params"][w])
    bad = []
    for w in range(NCCL_WINDOWS):
        (loss_rel, rel), (rerun_loss, rerun_rel) = diff("mesh", "alone", w), diff("rerun", "alone", w)
        loss_tol, rel_tol = max(GRAPH_LOSS_RTOL, 3 * rerun_loss), max(REL_TOL, 3 * rerun_rel[0])
        print(f"[{smi}] NCCL group of 1 rank, window {w + 1} of fit(superstep={SUPERSTEP}) from step 0 (step "
              f"{nccl['mesh']['hist'][w]['step']}): against the run without a mesh: loss rel {loss_rel:.2e}, params "
              f"rel L2 {rel[0]:.2e} ({rel[1]}); two runs without a mesh: {rerun_loss:.2e}, {rerun_rel[0]:.2e} "
              f"({rerun_rel[1]}); tolerances {loss_tol:.2e}, {rel_tol:.2e}")
        if not (loss_rel <= loss_tol and rel[0] <= rel_tol):
            bad.append(w + 1)
    print(f"[{smi}] NCCL window: captured {nccl['captured']}, graph {[h['graph'] for h in nccl['mesh']['hist']]}, "
          f"all-reduces issued from Python {nccl['issued']} (the warm-up step's and the capture's; the replays run "
          f"the captured one); replayed window {nccl['mesh']['replay_ms']:.2f} ms/step against "
          f"{nccl['alone']['replay_ms']:.2f} and {nccl['rerun']['replay_ms']:.2f} without a mesh")
    if not (nccl["captured"] and nccl["issued"] == 2 and all(h["graph"] for h in nccl["mesh"]["hist"])
            and len(nccl["mesh"]["hist"]) == NCCL_WINDOWS and not bad):
        raise AssertionError(f"the NCCL superstep windows disagree with the windows without a mesh (windows {bad})")

    counts = {k: sum(r["counts"][k] for r in res) + nccl["counts"][k] for k in res[0]["counts"]}
    if not all(counts.values()):
        raise AssertionError(f"the parallel phase did not run every trunk and trilinear kernel: {counts}")
    errs = {}
    for r, x in enumerate(res):
        print(f"rank {r} held at its own calls: DP trunk at {x['shapes']['dp_trunk_points']} points, joint_step_tp "
              f"trunk at {x['shapes']['tp_trunk_points']} points, sharded lookups on grids {x['shapes']['tp_grids']}")
        if not (x["shapes"]["dp_trunk_points"] and x["shapes"]["tp_trunk_points"] and x["shapes"]["tp_grids"]):
            raise AssertionError(f"rank {r}: a kernel of the parallel path was not held at its own calls")
        for k, v in x["errs"].items():
            errs[k] = max(errs.get(k, 0.0), v)
    print(f"parallel phase: {ranks_s:.1f} s for the reference and the {PARALLEL_RANKS} ranks, {nccl_s:.1f} s "
          f"for the NCCL rank; launches {counts}")
    return {"parallel": counts}, errs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one NVIDIA GPU.")
    parser.add_argument("--lookup-points", metavar="FILE",
                        help="also save the captured lookup points there (torch.save), for tools/lookup_times.py")
    args = parser.parse_args(argv)
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from poseprobe_tpu_torch.models import scene_nerf
    from poseprobe_tpu_torch.ops import _build, compositing, fused_composite, fused_mlp, grid as grid_ops, layout, pe
    from poseprobe_tpu_torch.train import trainer as trainer_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    compiled = _build.build(force=True)
    print(f"built kernels {sorted(compiled)} in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    joint = trainer_mod.build_trainer(small=SMALL, device=DEVICE)
    om, ot = joint.cfg.object_model, joint.cfg.object_train
    G = om.world_size[0]
    print(f"joint trainer built in {time.perf_counter() - t0:.1f} s: grid {om.world_size} + "
          f"{om.rgbnet_dim}-channel k0, {ot.N_rand} object rays, {om.n_samples} samples per ray, "
          f"chord-bound K {joint._mask_k}")
    if om.world_size != (G, G, G):
        raise AssertionError(f"expected a cubic grid, got {om.world_size}")
    C = 1 + om.rgbnet_dim

    records = check_trunk_kernels(fused_mlp, scene_nerf, pe)
    records += check_posenc_kernels(pe, fused_mlp, scene_nerf)
    records += check_layout_kernels(layout, G ** 3, C, _row_pad(C))
    joint.global_step = 1
    early = capture_lookup_points(grid_ops, joint, "early")
    records += check_trilinear_kernels(grid_ops, G, ot.N_rand * joint._mask_k, ot.N_rand * om.n_samples, early)
    del early
    records += check_composite_kernels(fused_composite, compositing, ot.N_rand, joint._mask_k, om.n_samples)
    print("kernels:", json.dumps([r["name"] for r in records]))

    by_phase = drive_early(fused_mlp, grid_ops, layout, pe, joint)
    del joint
    by_phase.update(drive_slice(fused_mlp, pe, trainer_mod))
    by_phase.update(drive_fit({"fused_mlp": fused_mlp, "grid": grid_ops, "layout": layout,
                               "fused_composite": fused_composite}, trainer_mod))
    work = tempfile.mkdtemp(prefix="poseprobe_smoke_")
    try:
        root = os.path.join(work, "DTU", "scan_fixture")     # its masks go to .../idrmasks/scan_fixture
        t0 = time.perf_counter()
        preset_counts, preset_errs, preset = drive_preset({"fused_mlp": fused_mlp, "grid": grid_ops}, trainer_mod, root)
        by_phase.update(preset_counts)
        preset_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cli_counts, cli_errs = drive_cli({"fused_mlp": fused_mlp, "grid": grid_ops}, trainer_mod, root, preset)
        by_phase.update(cli_counts)
        cli_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        last_counts, last_errs = drive_last_paths({"fused_mlp": fused_mlp, "grid": grid_ops}, trainer_mod, work,
                                                  root, preset)
        by_phase.update(last_counts)
        last_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    parallel_counts, parallel_errs = drive_parallel(trainer_mod, smi)
    by_phase.update(parallel_counts)
    parallel_s = time.perf_counter() - t0
    # last, so that the torch.profiler windows of the phases above run before its long traced steps
    t0 = time.perf_counter()
    widths_counts, widths_errs, widths_records = drive_trunk_widths({"fused_mlp": fused_mlp, "grid": grid_ops},
                                                                    trainer_mod)
    by_phase.update(widths_counts)
    records += widths_records
    by_phase.update(drive_long_rays({"fused_composite": fused_composite}, trainer_mod))
    widths_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ckpt_counts, ckpt_records = drive_trunk_ckpt({"fused_mlp": fused_mlp}, scene_nerf, pe, trainer_mod)
    by_phase.update(ckpt_counts)
    records += ckpt_records
    ckpt_s = time.perf_counter() - t0
    for rec in records:
        for tag, errs in (("widths", widths_errs), ("preset", preset_errs), ("cli", cli_errs),
                          ("last_paths", last_errs), ("parallel", parallel_errs)):
            if rec["name"] in errs:
                rec[f"{tag}_max_abs_err"] = errs[rec["name"]]
                rec["max_abs_err"] = max(rec["max_abs_err"], errs[rec["name"]])
        rec["launches_by_phase"] = {ph: c[rec["name"]] for ph, c in by_phase.items() if rec["name"] in c}
        rec["launches"] = sum(rec["launches_by_phase"].values())
        if rec["launches"] == 0 and rec["name"] not in OFF_PATH:
            raise AssertionError(f"{rec['name']} was never launched on the main path")
    if args.lookup_points:
        torch.save({label: [(gs, wg, p.cpu(), lo.cpu(), hi.cpu()) for gs, wg, p, lo, hi in sets]
                    for label, sets in CAPTURED.items()}, args.lookup_points)
        print(f"lookup points saved to {args.lookup_points}")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, the widths and long-ray phases "
          f"{widths_s:.1f} s, the checkpoint strides' phase {ckpt_s:.1f} s, the preset phase {preset_s:.1f} s, the cli phase {cli_s:.1f} s, the last paths' phase "
          f"{last_s:.1f} s and the parallel phase {parallel_s:.1f} s of it")
    print(smi)                          # again beside the numbers: the head of a long log may be cut
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
