"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--lookup-points FILE]

Builds the port's CUDA kernels from `poseprobe_tpu_torch/csrc/` (four
sources, one nvcc each, in parallel) and holds each kernel against its plain
PyTorch version on the card:
* the fused-trunk kernels at the mid-phase fine render's 393,216 points and
  at a ragged point count;
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
  the wrapper's device events per call.
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
rays counted, and is profiled (eager and graph step time, device time, busy
share, peak memory; `profile_step.profile_phase`).
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
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import torch

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor-core rate and HBM rate
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12          # float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12
FINE_POINTS = (1024 + 2 * 256) * 256   # mid-phase fine render: (rays + corres pair rays) x 256
RAGGED_POINTS = 100_003                # not a multiple of the 128-point tile
REL_TOL = 2e-2                         # max abs error allowed, as a fraction of max |twin|
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
        enc = torch.nn.functional.pad(enc, (0, fused_mlp.IN_PAD - enc.shape[1])).contiguous()
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
        ms = {
            "fwd": _time_ms(lambda: fused_mlp.trunk_fwd(enc, w, b, L, skip)),
            "fwd_plain": _time_ms(lambda: fused_mlp.trunk_fwd_plain(enc, w, b, L, skip)),
            "bwd": _time_ms(lambda: fused_mlp.trunk_bwd(enc, g_feat, g_dens, feat, acts, w, b, L, skip)),
            "bwd_plain": _time_ms(lambda: fused_mlp.trunk_bwd_plain(enc, g_feat, g_dens, feat, acts, w, b,
                                                                     L, skip)),
        }
        macs = _trunk_macs(cfg) * n
        wb = (w.numel() + b.numel()) * 2
        fwd_bytes = enc.numel() * 2 + wb + n * 256 * 2 + n * 4 + acts.numel() * 2
        bwd_bytes = (enc.numel() * 2 + g_feat.numel() * 2 + n * 2 + feat.numel() * 2 + acts.numel() * 2
                     + w.numel() * 2 + n * fused_mlp.IN_PAD * 2 + (w.numel() + b.numel()) * 4)
        for name, flops, nbytes, err, line in (("trunk_fwd", 2 * macs, fwd_bytes, f_abs, 127),
                                               ("trunk_bwd", 4 * macs, bwd_bytes, b_abs, 284)):
            kind = name.split("_")[1]
            bound_ms, bound_by = _bound(flops, nbytes)
            records[name] = {
                "name": name, "route": "cuda", "source": "poseprobe_tpu_torch/csrc/fused_trunk.cu",
                "replaces": f"poseprobe_tpu/ops/pallas/fused_mlp.py:{line}", "launches": 0,
                "max_abs_err": err, "ms": ms[kind], "plain_ms": ms[kind + "_plain"],
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
            print(f"{name} N={n}: kernel {ms[kind]:.3f} ms, twin {ms[kind + '_plain']:.3f} ms, "
                  f"bound {bound_ms:.3f} ms ({bound_by}: {flops / 1e12:.3f} TFLOP, {nbytes / 1e9:.3f} GB)")
        records["trunk_fwd"].update(_trunk_fwd_no_acts(fused_mlp, enc, w, b, L, skip, 2 * macs))
        records["trunk_bwd"].update(_trunk_bwd_parts(fused_mlp, enc, g_feat, g_dens, feat, acts, w, b, L, skip))
    return [records["trunk_fwd"], records["trunk_bwd"]]


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
    per_block = sum(K for K, *_ in fused_mlp.layout(L, skip, fused_mlp.H)) * fused_mlp.H * 2
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
    out = fused_mlp._bwd_outputs(n, w, b, L)
    launch = lambda kernels: fused_mlp._bwd_launch(  # noqa: E731
        enc, g_feat, g_dens, feat, acts, w, out, L, skip, kernels)
    parts = {"chain_ms": _time_ms(lambda: launch(("chain",))), "dw_ms": _time_ms(lambda: launch(("dw",)))}
    nb = lambda t: float(t.numel() * t.element_size())  # noqa: E731
    denc, dw, db, gsave = out
    floor_bytes = (2 * nb(acts) + 2 * nb(gsave) + nb(g_feat) + nb(feat) + nb(g_dens) + 2 * nb(enc) + nb(w)
                   + nb(dw) + nb(db))
    print(f"trunk_bwd N={n} by kernel: chain {parts['chain_ms']:.3f} ms, dW {parts['dw_ms']:.3f} ms")
    print(f"trunk_bwd N={n}: floor of the two-kernel design {floor_bytes / PEAK_HBM_BYTES * 1e3:.3f} ms "
          f"({floor_bytes / 1e9:.3f} GB at {PEAK_HBM_BYTES / 1e12:.2f} TB/s)")
    return parts


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
                  and e.self_device_time_total > 0 and not (flush and "Memcpy" in e.key)]
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


def capture_lookup_points(grid_ops, tr, label: str) -> list:
    """The points of every grid lookup of the joint trainer's next step, in
    call order: [(grid shape, with_grad, points [N, 3], lo, hi)]; kept in
    CAPTURED[label]."""
    seen = []
    kernels = grid_ops.trilinear_sample, grid_ops.trilinear_sample_with_grad

    def watch(fn, with_grad):
        def call(grid, xyz, lo, hi):
            seen.append((tuple(grid.shape), with_grad, xyz.detach().reshape(-1, 3).clone(),
                         torch.as_tensor(lo, device=DEVICE).float(), torch.as_tensor(hi, device=DEVICE).float()))
            return fn(grid, xyz, lo, hi)
        return call

    grid_ops.trilinear_sample, grid_ops.trilinear_sample_with_grad = watch(kernels[0], False), watch(kernels[1], True)
    try:
        tr.step()
    finally:
        grid_ops.trilinear_sample, grid_ops.trilinear_sample_with_grad = kernels
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
    start = rand(N, 1) * 0.6 - 0.1                                 # some rays start inside
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
    worst = {"fwd": 0.0, "bwd": 0.0}
    for N, S in ((n_rays, K), (n_rays, n_samples), (1000, 7), (37, 1000)):
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
            f_err = max(float((o[keep] - r[keep]).abs().max()) for o, r in zip(outs, refs))
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
            print(f"composite N={N} S={S} inv_s={inv_s:g}: fwd max abs err {f_err:.3e} (tolerance {out_tol}), "
                  f"bwd max abs err {b_err:.3e} (tolerance {grad_rel} of max |plain| + {grad_abs}), "
                  f"{int((~keep).sum())} rays at the gate left out")
            if not (f_err <= out_tol and b_ok):
                raise AssertionError(f"composite kernel disagrees with its plain version at N={N} S={S} "
                                     f"inv_s={inv_s}")
            if (N, S) == (n_rays, K):
                worst = {"fwd": max(worst["fwd"], f_err), "bwd": max(worst["bwd"], b_err)}

    args, cts = _composite_case(n_rays, K, 20.0, dist, seed=11)
    ns = float(n_rays * K)
    src, line = "fused_composite.cu", "poseprobe_tpu/ops/pallas/fused_composite.py:84"
    if not _FLUSH:
        _FLUSH[:] = [torch.empty(2 ** 24, device=DEVICE), torch.empty(2 ** 24, device=DEVICE)]
    # the bare launches, on buffers made once, with the wrapper's launch plan
    lib, ptr, chk = fused_composite._lib(), fused_composite._ptr, fused_composite._check
    stream = torch.cuda.current_stream().cuda_stream
    outs = [torch.empty_like(o) for o in fused_composite.composite_fwd(*args)]
    grads = [torch.empty_like(t) for t in (args[0], args[1], args[3], args[4])] + [torch.empty((n_rays, 2), device=DEVICE)]
    ins, ct_ptrs = [ptr(t) for t in args], [ptr(t) for t in cts]
    names = lambda arrays: [a for a, _ in arrays]  # noqa: E731
    fplan = fused_composite.launch_plan(n_rays, K, dict(zip(names(fused_composite.FWD_ARRAYS), ins[:5] + [ptr(outs[0])])),
                                        backward=False)
    bplan = fused_composite.launch_plan(n_rays, K, dict(zip(names(fused_composite.BWD_ARRAYS), ins[:5] + ct_ptrs[:1]
                                                            + [ptr(t) for t in grads[:4]])), backward=True)
    geo = lambda p: (n_rays, K, p.rays_per_block, p.run, p.bulk_full, p.bulk_last, p.smem_bytes)  # noqa: E731
    print(f"composite launch plans at [{n_rays}, {K}]: forward {fplan}, backward {bplan}")
    fns = {
        "fwd_kernel": lambda: chk(lib, lib.composite_fwd(*ins, *geo(fplan), *[ptr(t) for t in outs], stream),
                                  "composite_fwd"),
        "bwd_kernel": lambda: chk(lib, lib.composite_bwd(*ins, *ct_ptrs, *geo(bplan), *[ptr(t) for t in grads],
                                                         stream), "composite_bwd"),
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
    return records


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


def drive_early(fused_mlp, grid_ops, layout, tr) -> dict:
    """Early-phase steps (object branch on) of the bench-scale joint trainer.
    Returns the kernels' launch counts of the main-path runs."""
    om, ot, sm = tr.cfg.object_model, tr.cfg.object_train, tr.cfg.scene_model

    def counts():
        return {"trunk_fwd": fused_mlp.fwd_launches, "trunk_bwd": fused_mlp.bwd_launches,
                "trilinear_fwd": grid_ops.fwd_launches, "trilinear_bwd": grid_ops.bwd_launches,
                "transpose2d": layout.transpose2d_launches, "transpose_slice": layout.transpose_slice_launches,
                "materialize": layout.materialize_launches}

    def reset():
        fused_mlp.fwd_launches = fused_mlp.bwd_launches = 0
        grid_ops.fwd_launches = grid_ops.bwd_launches = 0
        layout.transpose2d_launches = layout.transpose_slice_launches = layout.materialize_launches = 0

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
    # per step: the scene half's one coarse trunk render, the deformed 1-channel value+gradient lookup, the
    # merged 13-channel lookup and the reprojection term's 1-channel lookup, all on the grids' own layout
    expect = {"trunk_fwd": steps, "trunk_bwd": steps, "trilinear_fwd": 3 * steps, "trilinear_bwd": 3 * steps,
              "transpose2d": 0, "transpose_slice": 0, "materialize": 0}
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


def drive_slice(fused_mlp, trainer_mod) -> dict:
    """Coarse-phase and mid-phase steps of the bench-scale scene trainer.
    Returns the trunk kernels' launch counts per phase."""
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
        counts = (fused_mlp.fwd_launches, fused_mlp.bwd_launches)
        losses = [float(m["loss_total"]) for m in metrics]
        flags = tr.phase_flags(start)
        print(f"phase {phase} (step {start}, fine_on={flags['fine_on']}, "
              f"depth_cons_on={flags['depth_cons_on']}): {dt * 1e3:.2f} ms/step, "
              f"{sm.rand_rays / dt:.1f} rays/s, loss {losses[0]:.5f} -> {losses[-1]:.5f}, "
              f"psnr {float(metrics[-1]['psnr_scene']):.3f}, launches fwd {counts[0]} bwd {counts[1]}")
        if not all(math.isfinite(x) for m in metrics for x in (float(v) for v in m.values())):
            raise AssertionError(f"non-finite metrics in the {phase} phase")
        if counts[0] == 0 or counts[1] == 0:
            raise AssertionError(f"the {phase} phase did not run through both trunk kernels")
        launches[phase] = {"trunk_fwd": counts[0], "trunk_bwd": counts[1]}
        graph = check_superstep(tr, phase, lambda: {"trunk_fwd": fused_mlp.fwd_launches,
                                                    "trunk_bwd": fused_mlp.bwd_launches}, reset)
        if graph != {k: v // steps * SUPERSTEP for k, v in launches[phase].items()}:
            raise AssertionError(f"the {phase} superstep window did not launch the trunk kernels of "
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
    worst = dict.fromkeys(("trilinear_fwd", "trilinear_bwd", "trunk_fwd", "trunk_bwd"), 0.0)
    for i, (gs, wg, pts, lo, hi) in enumerate(lookups):
        g = torch.Generator(device=DEVICE).manual_seed(100 + i)
        grid = torch.randn(gs, generator=g, device=DEVICE)
        ct_v = torch.randn((pts.shape[0], gs[0]), generator=g, device=DEVICE)
        ct_g = torch.randn((pts.shape[0], gs[0], 3), generator=g, device=DEVICE) if wg else None
        fwd = list(zip(grid_ops.trilinear_fwd(grid, pts, lo, hi, wg), grid_ops.trilinear_fwd_plain(grid, pts, lo, hi, wg)))
        bwd = list(zip(grid_ops.trilinear_bwd(grid, pts, lo, hi, ct_v, ct_g, True, True),
                       grid_ops.trilinear_bwd_plain(grid, pts, lo, hi, ct_v, ct_g, True, True)))
        torch.cuda.synchronize()
        for name, pairs in (("trilinear_fwd", fwd), ("trilinear_bwd", bwd)):
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
    if not (lookups and calls):
        raise AssertionError(f"{label}: the step made {len(lookups)} lookups and {len(calls)} trunk calls")
    print(f"{label} kernels against their plain versions at the step's {len(lookups)} lookups and {len(calls)} "
          f"trunk call(s): worst max abs err " + json.dumps({k: float(f"{v:.3e}") for k, v in worst.items()}))
    return worst


def drive_preset(mods: dict, trainer_mod) -> tuple[dict, dict]:
    """The published `dtu_generic` preset trained from a DTU-layout dataset on
    disk: the port's loader, matcher and feature maps, `fit()` from step 0
    across the activation of view 2 in superstep windows, then one superstep
    window past the last `pg_scale` doubling, where the surface-feature term
    runs on the 96^3 grid, after the kernels are held against their plain
    versions at that step's shapes. Returns the kernels' launch counts of
    both runs and those checks' worst errors."""
    import shutil
    import tempfile
    from poseprobe_tpu_torch.config.presets import dtu_generic
    from poseprobe_tpu_torch.data import loaders, synthetic
    from poseprobe_tpu_torch.eval.vgg_features import get_multi_features
    from poseprobe_tpu_torch.pose_init import matching
    from tools.dtu_fixture import write_dtu
    fused_mlp, grid_ops = mods["fused_mlp"], mods["grid"]

    def counts():
        return {"trunk_fwd": fused_mlp.fwd_launches, "trunk_bwd": fused_mlp.bwd_launches,
                "trilinear_fwd": grid_ops.fwd_launches, "trilinear_bwd": grid_ops.bwd_launches}

    def reset():
        fused_mlp.fwd_launches = fused_mlp.bwd_launches = 0
        grid_ops.fwd_launches = grid_ops.bwd_launches = 0

    H, W = PRESET_HW
    tmp = tempfile.mkdtemp(prefix="poseprobe_preset_")
    try:
        root = os.path.join(tmp, "DTU", "scan_fixture")     # its masks go to .../idrmasks/scan_fixture
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
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
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
    # step time eager and in graph windows (in turns), device time and busy share under torch.profiler
    from poseprobe_tpu_torch import profile_step
    prof = profile_step.profile_phase(tr, "preset", start, 8, SUPERSTEP, None)
    print(json.dumps({k: v for k, v in prof.items() if k not in ("eager", "graph")}
                     | {m: {k: v for k, v in prof[m].items() if k not in ("top", "top_host_ops")}
                        for m in ("eager", "graph")}))
    return {"preset": fit_counts, "preset_graph": graph}, errs


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
    records += check_layout_kernels(layout, G ** 3, C, _row_pad(C))
    joint.global_step = 1
    early = capture_lookup_points(grid_ops, joint, "early")
    records += check_trilinear_kernels(grid_ops, G, ot.N_rand * joint._mask_k, ot.N_rand * om.n_samples, early)
    del early
    records += check_composite_kernels(fused_composite, compositing, ot.N_rand, joint._mask_k, om.n_samples)
    print("kernels:", json.dumps([r["name"] for r in records]))

    by_phase = drive_early(fused_mlp, grid_ops, layout, joint)
    del joint
    by_phase.update(drive_slice(fused_mlp, trainer_mod))
    by_phase.update(drive_fit({"fused_mlp": fused_mlp, "grid": grid_ops, "layout": layout,
                               "fused_composite": fused_composite}, trainer_mod))
    t0 = time.perf_counter()
    preset_counts, preset_errs = drive_preset({"fused_mlp": fused_mlp, "grid": grid_ops}, trainer_mod)
    by_phase.update(preset_counts)
    preset_s = time.perf_counter() - t0
    for rec in records:
        if rec["name"] in preset_errs:
            rec["preset_max_abs_err"] = preset_errs[rec["name"]]
            rec["max_abs_err"] = max(rec["max_abs_err"], preset_errs[rec["name"]])
        rec["launches_by_phase"] = {ph: c[rec["name"]] for ph, c in by_phase.items() if rec["name"] in c}
        rec["launches"] = sum(rec["launches_by_phase"].values())
        if rec["launches"] == 0 and rec["name"] not in OFF_PATH:
            raise AssertionError(f"{rec['name']} was never launched on the main path")
    if args.lookup_points:
        torch.save({label: [(gs, wg, p.cpu(), lo.cpu(), hi.cpu()) for gs, wg, p, lo, hi in sets]
                    for label, sets in CAPTURED.items()}, args.lookup_points)
        print(f"lookup points saved to {args.lookup_points}")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, the preset phase {preset_s:.1f} s of it")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
