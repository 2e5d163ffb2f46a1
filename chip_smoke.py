"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `poseprobe_tpu_torch/csrc/` (four
sources, one nvcc each, in parallel) and holds each kernel against its plain
PyTorch version on the card:
* the fused-trunk kernels at the mid-phase fine render's 393,216 points and
  at a ragged point count;
* the layout kernels (`transpose2d`, `transpose_slice`, `materialize`) at the
  96^3 x 13-channel grid's shapes and at ragged ones, bit for bit;
* the trilinear kernels at 96^3 with 1 channel (value + gradient) and 13
  channels (value), at the early step's point count, at 1024 x n_samples and
  at a ragged count, with points on voxel corners, on the border and outside;
  the 13-channel backward also with POSEPROBE_SCATTER_BARRIER=1 (the staged
  scatter through `materialize`), against the twin and the direct scatter;
* the fused alpha-composite kernels (forward and hand-written backward) at the
  early step's [1024 rays, chord-bound K samples], at the dense
  [1024, n_samples], at ragged shapes, for a soft and a sharp NeuS sigmoid,
  with saturated, grazing and masked rays.
Beside each kernel's time stands the time of the one PyTorch call that
computes the same function, where there is one (a copy for the layout
kernels, `F.grid_sample` and its backward for the trilinear ones): timed and
checked here, used nowhere in the port.
Then it drives the training step at bench scale (bf16 trunk): a few
coarse-phase and mid-phase steps of the scene-only trainer
(`build_scene_trainer`) and a few early-phase steps of the joint trainer
(`build_trainer`, object branch on), checking that the losses are finite,
that the kernels carried every trunk render and every grid lookup (launch
counters), that one step's loss through the kernels agrees with the same
step through the plain PyTorch versions, and that a step with
POSEPROBE_SCATTER_BARRIER=1 (the scatter updates pass through `materialize`)
gives the same loss. Last it drives `JointTrainer.fit()` at the same scale
with PnP pose seeding and the fused composite on: the PnP chain at
construction, the early steps through the composite kernels, the activation
of the third view (PnP against the probe, photometric gate, guarded warmup and
fixed-ray scores rendered on the card), a mask-cache refresh and a BA-polish
event, then the probe health check and a validation render. OpenCV is
optional: without it PnP runs the numpy RANSAC and the BA polish and the match
refinement decline, as in the reference; the script says which path ran.

Prints the card (`nvidia-smi` name and power limit), the build time, errors
and times, one JSON line `{"kernels": [...]}` and, last, one JSON line
`{"ok": true, "device": {...}}`. Any failed check raises: the script exits
non-zero and prints no result. It needs a CUDA card and the repository
around it; it has no CPU path.
"""
from __future__ import annotations

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
DEVICE = "cuda"
SMALL = False                          # bench scale


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
    return [records["trunk_fwd"], records["trunk_bwd"]]


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
    for shape in ((V, P), (100_003, C), (7,), (3, 5, 7, 11)):
        x = rand(*shape)
        y = layout.materialize(x)
        if not (torch.equal(y, x) and y.data_ptr() != x.data_ptr()):
            raise AssertionError(f"materialize differs from its twin at {shape}")
    torch.cuda.synchronize()
    print("layout kernels: bit-identical to their twins at every shape")
    # the early step: [C, V] -> [V, C] rows for the gather, [V, P] -> [C, V] after the scatter
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
        _record("materialize", src, "poseprobe_tpu/ops/pallas/layout.py:73", 0.0,
                timed(layout.materialize, xss), timed(layout.materialize_plain, xss),
                0.0, nb(xss[0]) * 2, timed(lambda x: x.clone(), xss)),
    ]


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


def check_trilinear_kernels(grid_ops, G: int, n_path: int, n_full: int) -> list:
    """trilinear_fwd / trilinear_bwd against the autograd twin (nested lerps)
    for C = 1 with gradient and C = 13 value-only; records for the 13-channel
    lookup at the early step's point count `n_path`."""
    lo = torch.tensor([-0.5, -0.45, -0.55], device=DEVICE)
    hi = torch.tensor([0.5, 0.55, 0.45], device=DEVICE)
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

    # times at the early step's shapes
    records = []
    gshape = (13, G, G, G)
    grid, pts, ct_v, ct_g = _trilinear_case(grid_ops, G, 13, n_path, lo, hi, seed=5)
    rows = grid_ops.rows_from_grid(grid)
    idx8 = grid_ops._corner_data(gshape, pts, lo, hi)[0]
    n_rows = float(torch.unique(idx8).numel())                    # the rows this run's points need
    N, V, P = float(n_path), float(G ** 3), grid_ops.row_pad(13)
    gt = grid.clone().requires_grad_(True)
    out_t = grid_ops.trilinear_sample_reference(gt, pts, lo, hi)
    d_twin, = torch.autograd.grad(out_t, gt, ct_v, retain_graph=True)

    # the library's call for the same function: grid_sample on a 5-D input, border padding,
    # align_corners, coordinates normalised to [-1, 1] in (z, y, x) order; its autograd backward
    # is the library's scatter. Timed here and held against the twin; the port never calls it.
    coords = (2.0 * grid_ops.normalize_coords(pts, lo, hi) - 1.0)[:, [2, 1, 0]].reshape(1, 1, 1, -1, 3).contiguous()
    sample = lambda g: torch.nn.functional.grid_sample(  # noqa: E731
        g[None], coords, mode="bilinear", padding_mode="border", align_corners=True)
    gl = grid.clone().requires_grad_(True)
    out_l = sample(gl)                                            # [1, C, 1, 1, N]
    ct_l = ct_v.t().reshape(1, 13, 1, 1, -1).contiguous()
    d_lib, = torch.autograd.grad(out_l, gl, ct_l, retain_graph=True)
    l_err = max(_tri_close("grid_sample value", out_l.detach()[0, :, 0, 0].t(), out_t.detach()),
                _tri_close("grid_sample d_grid", d_lib, d_twin))
    print(f"library call (F.grid_sample and its backward) against the twin: max abs err {l_err:.3e}")

    # the staged scatter of POSEPROBE_SCATTER_BARRIER=1 (updates written out, passed through
    # `materialize`, added by the second kernel) against the twin and the direct scatter
    d_direct, _ = grid_ops.trilinear_bwd(rows, pts, lo, hi, gshape, ct_v, None, True, False)
    before = grid_ops.layout.materialize_launches
    os.environ["POSEPROBE_SCATTER_BARRIER"] = "1"
    try:
        d_staged, _ = grid_ops.trilinear_bwd(rows, pts, lo, hi, gshape, ct_v, None, True, False)
        staged_ms = _time_ms(lambda: grid_ops.trilinear_bwd(rows, pts, lo, hi, gshape, ct_v, None, True, False))
    finally:
        os.environ.pop("POSEPROBE_SCATTER_BARRIER")
    if grid_ops.layout.materialize_launches == before:
        raise AssertionError("the staged scatter did not pass through materialize")
    s_err = max(_tri_close("staged d_grid against the twin", d_staged, d_twin),
                _tri_close("staged d_grid against the direct scatter", d_staged, d_direct),
                _tri_close("direct d_grid against the twin", d_direct, d_twin))
    print(f"trilinear_bwd C=13 N={n_path} with POSEPROBE_SCATTER_BARRIER=1 (materialize + scatter_rows): "
          f"d_grid max abs err {s_err:.3e} against the twin and the direct scatter, {staged_ms:.4f} ms")

    records.append(_record(
        "trilinear_fwd", "trilinear.cu", "poseprobe_tpu/ops/grid.py:255", worst["fwd"],
        _time_ms(lambda: grid_ops.trilinear_fwd(rows, pts, lo, hi, gshape, False)),
        _time_ms(lambda: grid_ops.trilinear_sample_reference(grid, pts, lo, hi)),
        N * 13 * 8 * 3, n_rows * 13 * 4 + N * 12 + N * 13 * 4, _time_ms(lambda: sample(grid)), PEAK_F32_FLOPS))
    # the merged 13-channel lookup's backward on the path: d_grid only (its points carry no
    # gradient). `ms` is the whole function, as the twin and the library compute it (zero-fill,
    # scatter kernel, transpose_slice -> dense [C, X, Y, Z]); `kernel_ms` is the scatter kernel
    # alone on a buffer already zeroed, whose traffic is the cotangents and the touched rows.
    rec = _record(
        "trilinear_bwd", "trilinear.cu", "poseprobe_tpu/ops/grid.py:269", max(worst["bwd"], s_err),
        _time_ms(lambda: grid_ops.trilinear_bwd(rows, pts, lo, hi, gshape, ct_v, None, True, False)),
        _time_ms(lambda: torch.autograd.grad(out_t, gt, ct_v, retain_graph=True)),
        N * 13 * 8 * 4, N * 12 + N * 13 * 4 + V * 13 * 4,
        _time_ms(lambda: torch.autograd.grad(out_l, gl, ct_l, retain_graph=True)), PEAK_F32_FLOPS)
    lib, ptr = grid_ops._lib(), grid_ops._ptr
    d_rows = torch.zeros((G ** 3, P), device=DEVICE)
    stream = torch.cuda.current_stream().cuda_stream
    rec["kernel_ms"] = _time_ms(lambda: grid_ops._check(lib, lib.trilinear_bwd(
        ptr(rows), ptr(pts), ptr(lo), ptr(hi), ptr(ct_v), ptr(None), G, G, G, 13, P, n_path, ptr(d_rows),
        ptr(None), ptr(None), ptr(None), stream), "trilinear_bwd"))
    rec["kernel_bound_ms"] = _bound(N * 13 * 8 * 4, N * 12 + N * 13 * 4 + n_rows * P * 4, PEAK_F32_FLOPS)[0]
    rec["staged_ms"] = staged_ms
    print(f"trilinear_bwd: scatter kernel alone {rec['kernel_ms']:.4f} ms (bound {rec['kernel_bound_ms']:.4f} ms: "
          f"cotangents, points and {int(n_rows)} touched rows of {P} floats)")
    records.append(rec)
    # for the record: the 1-channel value+gradient lookup (the deformed SDF sample), d_grid and d_pts
    g1, p1, cv1, cg1 = _trilinear_case(grid_ops, G, 1, n_path, lo, hi, seed=6)
    r1 = grid_ops.rows_from_grid(g1)
    f1 = _time_ms(lambda: grid_ops.trilinear_fwd(r1, p1, lo, hi, (1, G, G, G), True))
    b1 = _time_ms(lambda: grid_ops.trilinear_bwd(r1, p1, lo, hi, (1, G, G, G), cv1, cg1, True, True))
    print(f"trilinear C=1 value+grad N={n_path}: fwd {f1:.4f} ms, bwd (d_grid + d_pts) {b1:.4f} ms")
    return records


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
    plain_fwd = lambda: fused_composite.fused_alpha_composite_plain(*args[:5], args[5][0], args[5][1])  # noqa: E731
    records = [
        # forward: sdf, cos, step, rgb (24 B) + mask (1 B) read, the weight written, per sample;
        # two sigmoids, a quotient, the scan and four multiply-adds: ~60 operations
        _record("composite_fwd", src, line, worst["fwd"],
                _time_ms(lambda: fused_composite.composite_fwd(*args), iters=50),
                _time_ms(plain_fwd, iters=50), ns * 60, ns * 29 + n_rays * 20, None, PEAK_F32_FLOPS),
        # backward: the same inputs and the weight cotangent read (29 B), d_sdf, d_cos, d_step,
        # d_rgb written (24 B), per sample; the forward's operations again plus the reverse scan
        _record("composite_bwd", src, line, worst["bwd"],
                _time_ms(lambda: fused_composite.composite_bwd(*args, *cts), iters=50),
                _time_ms(lambda: fused_composite.composite_bwd_plain(*args, *cts), iters=50),
                ns * 120, ns * 53 + n_rays * 28, None, PEAK_F32_FLOPS),
    ]
    # `ms` above is the wrapper (4 or 5 allocations, the launch, one sum): at this size the host's
    # enqueue time. `kernel_ms`: the bare launches back to back on buffers made once.
    lib, ptr, chk = fused_composite._lib(), fused_composite._ptr, fused_composite._check
    stream = torch.cuda.current_stream().cuda_stream
    outs = [torch.empty_like(o) for o in fused_composite.composite_fwd(*args)]
    grads = [torch.empty_like(t) for t in (args[0], args[1], args[3], args[4])] + [torch.empty((n_rays, 2), device=DEVICE)]
    ins = [ptr(t) for t in args]
    records[0]["kernel_ms"] = _time_ms(lambda: chk(lib, lib.composite_fwd(
        *ins, n_rays, K, *[ptr(t) for t in outs], stream), "composite_fwd"), iters=200)
    records[1]["kernel_ms"] = _time_ms(lambda: chk(lib, lib.composite_bwd(
        *ins, *[ptr(t) for t in cts], n_rays, K, *[ptr(t) for t in grads], stream), "composite_bwd"), iters=200)
    print(f"composite kernels alone, back to back: fwd {records[0]['kernel_ms']:.4f} ms, "
          f"bwd {records[1]['kernel_ms']:.4f} ms")
    return records


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
    # per step: the scene half's one coarse trunk render, the deformed 1-channel value+gradient lookup, the merged 13-channel
    # lookup (one transpose2d forward, one transpose_slice backward) and the
    # reprojection term's 1-channel lookup
    expect = {"trunk_fwd": steps, "trunk_bwd": steps, "trilinear_fwd": 3 * steps, "trilinear_bwd": 3 * steps, "transpose2d": steps,
              "transpose_slice": steps, "materialize": 0}
    if early != expect:
        raise AssertionError(f"the early phase's grid lookups did not all run through the kernels: "
                             f"{early}, expected {expect}")

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
    return {"early": early, "early_barrier": barrier}


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
    for phase, start, warm, steps in (("coarse", trainer_mod.N_ITERS + 1, 2, 8),
                                      ("mid", tr.fine_start + 1, 2, 8)):
        tr.global_step = start
        for _ in range(warm):
            tr.step()
        torch.cuda.synchronize()
        fused_mlp.fwd_launches = fused_mlp.bwd_launches = 0
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
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    try:
        hist = [dict(h) for h in tr.fit(n_steps, log_every=1)]
    finally:
        pnp_mod.pnp_from_matches, evaluator.test_time_pose_optim, evaluator.photometric_pose_score = originals
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    fit_counts = counts()
    events = spent["activation"] + spent["ba"] + spent["refresh"]
    print(f"fit: {n_steps} early steps across the activation of view 2 in {dt:.2f} s, {events:.3f} s of it in host "
          f"events ({(dt - events) / n_steps * 1e3:.2f} ms/step with the per-step metric read-back); activation "
          f"event {spent['activation']:.3f} s: PnP {spent['pnp']:.3f} s ({calls['pnp']} solve), warmup "
          f"{spent['warmup']:.3f} s ({calls['warmup']} x {cfg.camera.activation_pose_warmup} Adam iterations on 1024 "
          f"rays), fixed-ray scores {spent['score']:.3f} s ({calls['score']} x 2048 rays), the rest match geometry "
          f"and the chord-K re-bound; BA polish {spent['ba']:.3f} s; mask-cache refresh {spent['refresh']:.3f} s")
    print(f"fit: launches {fit_counts}")
    print(f"fit: loss {hist[0]['loss_total']:.5f} -> {hist[-1]['loss_total']:.5f}, psnr_obj "
          f"{hist[-1]['psnr_obj']:.3f}, psnr_scene {hist[-1]['psnr_scene']:.3f}, active views "
          f"{[h['n_active'] for h in hist]}")
    if [h["n_active"] for h in hist] != [2] * activate_at + [3] * (n_steps - activate_at) or tr.n_active != 3:
        raise AssertionError("view 2 was not activated at its step")
    if not all(math.isfinite(v) for h in hist for v in h.values()):
        raise AssertionError("non-finite metrics in fit")
    if not (calls["pnp"] == 1 and calls["warmup"] >= 1 and calls["score"] >= 2 and calls["ba"] == 1
            and calls["refresh"] == 1):
        raise AssertionError(f"fit did not run PnP, the warmup, the scores, one BA event and one refresh: {calls}")
    # every early step renders the object rays once: one composite forward and one backward
    if not (fit_counts["composite_fwd"] == fit_counts["composite_bwd"] == n_steps):
        raise AssertionError(f"the composite kernels did not carry every early step: {fit_counts}")
    if min(fit_counts.values()) < n_steps:
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
    return {"fit": fit_counts}


def main() -> int:
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
    records += check_layout_kernels(layout, G ** 3, C, grid_ops.row_pad(C))
    records += check_trilinear_kernels(grid_ops, G, ot.N_rand * joint._mask_k, ot.N_rand * om.n_samples)
    records += check_composite_kernels(fused_composite, compositing, ot.N_rand, joint._mask_k, om.n_samples)
    print("kernels:", json.dumps([r["name"] for r in records]))

    by_phase = drive_early(fused_mlp, grid_ops, layout, joint)
    del joint
    by_phase.update(drive_slice(fused_mlp, trainer_mod))
    by_phase.update(drive_fit({"fused_mlp": fused_mlp, "grid": grid_ops, "layout": layout,
                               "fused_composite": fused_composite}, trainer_mod))
    for rec in records:
        rec["launches_by_phase"] = {ph: c[rec["name"]] for ph, c in by_phase.items() if rec["name"] in c}
        rec["launches"] = sum(rec["launches_by_phase"].values())
        if rec["launches"] == 0:
            raise AssertionError(f"{rec['name']} was never launched on the main path")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
