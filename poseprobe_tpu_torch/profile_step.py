"""Where the time of the training step goes, on one GPU.

    python3 -m poseprobe_tpu_torch.profile_step [--steps 8] [--superstep K] [--composite]
                                               [--out TRACE_DIR] [--phases early coarse mid]
                                               [--trunk WIDTH L_3D]

For each phase cell of `build_trainer()` (early: step 1, object branch on;
coarse: step 10,001; mid: step 18,001) it times steps without the profiler
(host clock around synchronised steps), then traces the same number of steps
with `torch.profiler` and prints the device time per step, the device busy
share (device time / unprofiled step time), the device events per step, the
device time of the hand-written kernels (fused trunk; trilinear and layout;
fused alpha-composite), the kernels with the most device time and the most
frequent host (aten) ops.
With `--superstep K` it also runs the steps as K-step superstep windows
(`steps_scan(K)`: one captured CUDA graph replayed), timed in turns with the
eager steps (eager, graph, graph, eager), and prints the same for them, the
capture time of each cell and the peak device memory. After the phases it
prints the 60k-weighted rays/s of the measured step times (10k early steps at
object + scene rays, 8k coarse and 42k mid steps at scene rays), for each
mode. `--composite` turns on the fused alpha-composite kernels
(`use_pallas_composite`, off by default as in the reference). `--trunk 128
16` replaces the scene trunk by 8 layers of that width at that L_3D, as
`chip_smoke.py`'s trunk-width cells do (the narrow cell: 8x128, L_3D 16).
One JSON line per phase and one for the weighting; Chrome traces go to
`--out`.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from .train import trainer as trainer_mod


def _device_events(prof):
    """Kernels, copies and memsets: the events that run on the card (the CPU
    ops that launched them carry the same time and are left out)."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]


def _run(tr, mode: str, steps: int, k: int) -> None:
    """`steps` steps: eager, or as steps / k superstep windows."""
    if mode == "eager":
        for _ in range(steps):
            tr.step()
    else:
        for _ in range(steps // k):
            tr.steps_scan(k)


def _timed_ms(tr, mode: str, steps: int, k: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _run(tr, mode, steps, k)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def _traced(tr, name: str, mode: str, steps: int, k: int, step_ms: float, out: Path | None) -> dict:
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _run(tr, mode, steps, k)
        torch.cuda.synchronize()
    events = _device_events(prof)
    device_us = sum(e.self_device_time_total for e in events)
    launches = sum(e.count for e in events)
    trunk_us = sum(e.self_device_time_total for e in events if "trunk_" in e.key)
    grid_names = ("trilinear_", "scatter_rows", "rows_to_channels", "channels_to_rows", "tiled_transpose",
                  "materialize_kernel")
    grid_us = sum(e.self_device_time_total for e in events if any(n in e.key for n in grid_names))
    composite_us = sum(e.self_device_time_total for e in events        # the chunked kernels too
                       if "composite_fwd" in e.key or "composite_bwd" in e.key)
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    host_ops = sorted((e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CPU and e.key.startswith("aten::")),
                      key=lambda e: e.count, reverse=True)[:8]
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / f"{name}_{mode}.json"))
    result = {
        "step_ms": step_ms,
        "device_ms_per_step": device_us / 1e3 / steps,
        "busy_share": device_us / 1e3 / steps / step_ms,
        "launches_per_step": launches / steps,
        "trunk_kernels_ms_per_step": trunk_us / 1e3 / steps,
        "grid_kernels_ms_per_step": grid_us / 1e3 / steps,
        "composite_kernels_ms_per_step": composite_us / 1e3 / steps,
        "top": [{"kernel": e.key[:90], "ms_per_step": e.self_device_time_total / 1e3 / steps,
                 "calls_per_step": e.count / steps} for e in top],
        "top_host_ops": [{"op": e.key, "calls_per_step": e.count / steps,
                          "host_ms_per_step": e.cpu_time_total / 1e3 / steps} for e in host_ops],
    }
    print(f"{name} {mode}: {step_ms:.2f} ms/step unprofiled, device {result['device_ms_per_step']:.2f} ms/step "
          f"(busy {100 * result['busy_share']:.1f}%), {result['launches_per_step']:.0f} device "
          f"events/step, trunk kernels {result['trunk_kernels_ms_per_step']:.2f} ms/step, trilinear + "
          f"layout kernels {result['grid_kernels_ms_per_step']:.3f} ms/step, composite kernels "
          f"{result['composite_kernels_ms_per_step']:.4f} ms/step")
    for t in result["top"]:
        print(f"  {t['ms_per_step']:8.3f} ms  x{t['calls_per_step']:6.1f}  {t['kernel']}")
    print("  most frequent host ops: " + ", ".join(
        f"{o['op']} x{o['calls_per_step']:.0f}" for o in result["top_host_ops"]))
    return result


def profile_phase(tr, name: str, start: int, steps: int, superstep: int, out: Path | None) -> dict:
    """The phase's eager steps and, with `superstep` > 1, its superstep windows
    (steps rounded down to whole windows), timed in turns and then traced."""
    modes = ("eager", "graph") if superstep > 1 else ("eager",)
    if superstep > 1:
        steps = max(steps // superstep, 1) * superstep
    tr.global_step = start
    tr.drop_graphs()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        tr.step()
    capture_s = None
    if superstep > 1:
        t0 = time.perf_counter()
        tr.steps_scan(superstep)            # the cell's capture (its first step runs eagerly)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
    order = ("eager", "graph", "graph", "eager") if superstep > 1 else ("eager",)
    times = {m: [] for m in modes}
    for mode in order:
        times[mode].append(_timed_ms(tr, mode, steps, superstep))
    result = {"phase": name, "step": start, "steps": steps, "superstep": superstep}
    for mode in modes:
        step_ms = sum(times[mode]) / len(times[mode])
        result[mode] = dict(_traced(tr, name, mode, steps, superstep, step_ms, out),
                            step_ms_in_turns=times[mode])
    result["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    if capture_s is not None:
        graph = tr._graphs.graph
        result["capture_s"] = graph.capture_s
        result["first_window_s"] = capture_s
        print(f"{name}: capture of the cell {graph.capture_s:.3f} s (first window of {superstep} steps, "
              f"its eager first step and the capture included, {capture_s:.3f} s); step ms in turns "
              f"{times}; peak memory {result['peak_memory_gib']:.2f} GiB")
    else:
        print(f"{name}: peak memory {result['peak_memory_gib']:.2f} GiB")
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--superstep", type=int, default=1,
                    help="also run the steps as K-step superstep windows (CUDA-graph replay)")
    ap.add_argument("--composite", action="store_true",
                    help="use the fused alpha-composite kernels (use_pallas_composite=True)")
    ap.add_argument("--out", type=Path, default=None, help="directory for Chrome traces")
    ap.add_argument("--phases", nargs="+", default=["early", "coarse", "mid"],
                    choices=["early", "coarse", "mid"])
    ap.add_argument("--trunk", type=int, nargs=2, metavar=("WIDTH", "L_3D"), default=None,
                    help="the scene trunk as 8 layers of WIDTH at L_3D (build_trainer()'s workload otherwise)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    if args.trunk:
        cfg, data = trainer_mod._bench_workload(False, "bfloat16")       # build_trainer()'s workload
        scene = dataclasses.replace(cfg.scene_model, layers_feat=(args.trunk[0],) * 8, L_3D=args.trunk[1])
        tr = trainer_mod.JointTrainer(dataclasses.replace(cfg, scene_model=scene), data, device="cuda")
    else:
        tr = trainer_mod.build_trainer(device="cuda")
    if args.composite:
        tr.cfg = dataclasses.replace(tr.cfg, object_model=dataclasses.replace(
            tr.cfg.object_model, use_pallas_composite=True))
    starts = {"early": 1, "coarse": trainer_mod.N_ITERS + 1, "mid": tr.fine_start + 1}
    step_ms = {}
    for name in args.phases:
        result = profile_phase(tr, name, starts[name], args.steps, args.superstep, args.out)
        step_ms[name] = {mode: result[mode]["step_ms"] for mode in ("eager", "graph") if mode in result}
        print(json.dumps(result))
    if len(step_ms) == 3:
        for mode in step_ms["early"]:
            out = dict(weighted_rays_per_s(tr, {p: ms[mode] for p, ms in step_ms.items()}), mode=mode)
            print(f"60k-weighted ({mode}): {out['rays_per_s_60k_weighted']:.1f} rays/s, "
                  f"{out['seconds_for_60k_steps']:.0f} s for the 60k steps")
            print(json.dumps(out))


def weighted_rays_per_s(tr, step_ms: dict) -> dict:
    """60k-weighted rays/s from the per-phase step times, weighted as the
    reference's benchmark weights them: early steps carry object + scene rays."""
    n_iters, fine_start, max_iter = trainer_mod.N_ITERS, tr.fine_start, trainer_mod.MAX_ITER
    obj_rays, scene_rays = tr.cfg.object_train.N_rand, tr.cfg.scene_model.rand_rays
    steps = {"early": n_iters, "coarse": fine_start - n_iters, "mid": max_iter - fine_start}
    rays = {"early": obj_rays + scene_rays, "coarse": scene_rays, "mid": scene_rays}
    total_s = sum(steps[p] * step_ms[p] / 1e3 for p in steps)
    total_rays = sum(steps[p] * rays[p] for p in steps)
    return {"rays_per_s_60k_weighted": total_rays / total_s, "seconds_for_60k_steps": total_s,
            "step_ms": step_ms}


if __name__ == "__main__":
    main()
