"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Steps: build or load the port's kernels (`ops/_build.py`, into the fixed
`poseprobe_tpu_torch/build/`), make the cell's inputs and weights from
`--seed`, warm up the cell's own shapes, measure for `--seconds`, check what
the timed path produced against the plain reference, and print one JSON line
as the last line of standard output. The numbers compared, each beside its
limit, are also the last lines of standard error and the line's last key.

With `--trace 0` the line's metrics are the cell's end-to-end metrics; with
`--trace 1` its per-layer metrics: part of the window is timed without the
profiler (the `mfu_pct.*` metrics), then a short stretch is profiled
(`trace.py`) and each per-layer metric's reader (`metrics/<name>.py`) takes
its number from the spans, counters and the trace.

The run exits with another code than 0, printing no result, when there is no
CUDA device (or fewer than the cell asks for), when the port's config differs
from the configuration file (`guard.py`), or when `jax`, `jaxlib`, `flax` or
`poseprobe_tpu` is loaded in this process once the window has closed.
"""
from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "poseprobe_tpu")
os.environ.setdefault("USE_FLAX", "0")


class Refused(SystemExit):
    """A run that prints no result: the message goes to standard error."""

    def __init__(self, msg: str, code: int = 2):
        super().__init__(code)
        self.msg = msg


@dataclasses.dataclass
class Run:
    """What a driver and the readers share about one run."""
    cell: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    spans: dict = dataclasses.field(default_factory=dict)     # seconds of the benchmark's own spans
    values: dict = dataclasses.field(default_factory=dict)    # numbers read from the program (counters)
    work: dict = dataclasses.field(default_factory=dict)      # work of one unit, counted from the config


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads: the run, the trace of its traced stretch,
    the unprofiled part of the window (seconds and units) and the work of a unit."""
    run: Run
    trace: object
    unprofiled_s: float
    unprofiled_units: int
    trace_work: dict


def forbidden_modules(modules=None) -> list:
    """Top-level names (the part before the first dot, compared whole) of the
    loaded modules that belong to JAX or the JAX package."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def _device_info(torch, device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def _sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(run: Run, bench: dict, device=None) -> dict:
    """One run of the cell; returns the result object (the last line's keys).
    `device` None takes cuda:0 and needs the cell's count of cards; tests pass
    "cpu" to drive the rest of a run there."""
    import torch

    from . import manifest, trace as trace_mod

    cell = run.cell
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise Refused(f"the cell {cell['name']} needs {cell['chips']} CUDA device(s); "
                          f"torch.cuda.is_available() = {torch.cuda.is_available()}")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    run.device = torch.device(device)
    driver = manifest.driver(cell["driver"])
    window = driver.setup(run)

    # the window: whole units until --seconds have passed, each ending in a synchronise. The
    # memory peak runs from the cell's first step in set-up (the driver resets it there): a
    # captured step's buffers are allocated at its capture, and a replay allocates nothing
    setup_s = time.perf_counter() - PROCESS_START
    budget = run.seconds * (0.7 if run.trace else 1.0)
    units, t0 = 0, time.perf_counter()
    while True:
        window.unit()
        units += 1
        if time.perf_counter() - t0 >= budget:
            break
    _sync(torch, run.device)
    window_s = time.perf_counter() - t0
    peak = _device_info(torch, run.device)
    traced = None
    if run.trace:
        traced = trace_mod.traced(window.trace_unit, window.trace_units)
    attempted, failed = window.tally()
    loaded = forbidden_modules()
    if loaded:
        raise Refused(f"loaded in the process that measured: {', '.join(loaded)}", 3)

    window.close()                       # the program's state is freed before the reference runs
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    checks = window.check()
    correct = bool(checks) and all(c["value"] <= c["limit"] for c in checks) and failed == 0

    e2e, per_layer = manifest.cell_metrics(bench, cell["name"])
    metrics = {}
    if not run.trace:
        values = {"setup_s": setup_s,
                  "peak_mem_gib": peak["memory_peak_bytes"] / 2 ** 30,
                  cell["rate_metric"]: units * window.work_per_unit / window_s}
        for m in e2e:
            if m["name"] not in values:
                raise Refused(f"the cell {cell['name']} has no value for {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        ctx = Context(run=run, trace=traced, unprofiled_s=window_s, unprofiled_units=units,
                      trace_work=window.trace_work)
        for m in per_layer:
            value = manifest.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": peak}
    if run.trace:
        result["device"] = dict(peak, busy_s=traced.busy_s, window_s=traced.window_s)
        result["breakdown"] = {"device_ops": traced.device_ops, "idle_gaps": traced.idle_gaps}
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from . import manifest
    try:
        bench = manifest.benchmark()
        cell = manifest.workload(args.workload)
        run = Run(cell=cell, config=manifest.config(cell["config"]), seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), device=None)
        result = measure(run, bench)
    except Refused as r:
        print(f"portbench: {r.msg}", file=sys.stderr)
        return r.code
    print(f"portbench: {result['device']['kind']}, {_power_limit()}; {args.workload} seed {args.seed}",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    if not all(math.isfinite(m["value"]) for m in result["metrics"].values()):
        print("portbench: a metric is not finite", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
