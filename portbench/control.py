"""Readings from which a cell's limits are set (not run by the benchmark).

    python3 -m portbench.control --workload <cell> --seeds 1 2 3 ... \
        [--sides program control half_batch] [--out FILE]

For each seed it sets the cell up as a run does (the same driver, the same
sizes, the same checked steps or bands) and reads the compared numbers of
each side against the reference:
* `program`: the port's timed path, as a run reads it;
* `control`: the reference put in the program's place one precision step
  below the configuration (the MLPs' bfloat16 -> float8 e4m3, float32
  matmuls -> TF32);
* `half_batch` (training cells): the reference in the program's place with
  its photometric terms taken over half of the rays.
A render cell renders, at its own load, until every checked band is done.
One JSON line per seed and side; the last line sums up, per side and number,
the largest reading (the lower reading of `program`) and the smallest (the
upper reading of a control or a fault).
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

import torch

from . import manifest
from .run import Run


def readings(cell: str, seed: int, sides: list, device=None) -> dict:
    w = manifest.workload(cell)
    run = Run(cell=w, config=manifest.config(w["config"]), seed=seed, seconds=0.0, trace=False, device=None)
    run.device = torch.device(device or "cuda")
    window = manifest.driver(w["driver"]).setup(run)
    if w["driver"] == "render":
        while window.n <= max(window.sampled):
            window.unit()
    window.close()
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    return {side: window.readings(side) for side in sides}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sides", nargs="+", default=["program", "control"])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control needs a CUDA device", file=sys.stderr)
        return 2
    lines, summary = [], {}
    for seed in args.seeds:
        got = readings(args.workload, seed, args.sides)
        for side, nums in got.items():
            line = {"workload": args.workload, "seed": seed, "side": side, **nums}
            lines.append(line)
            print(json.dumps(line), flush=True)
            agg = summary.setdefault(side, {})
            for k, v in nums.items():
                lo, hi = agg.get(k, (v, v))
                agg[k] = (min(lo, v), max(hi, v))
    out = {"workload": args.workload, "seeds": args.seeds,
           "summary": {s: {k: {"min": lo, "max": hi} for k, (lo, hi) in agg.items()} for s, agg in summary.items()}}
    print(json.dumps(out), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(json.dumps(x) for x in lines + [out]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
