"""Device times of a tree's fused alpha-composite kernels.

    python3 tools/composite_times.py [--tree DIR]

Times the composite forward and backward of the `poseprobe_tpu_torch`
package found in DIR (default: this checkout) at [1024, 76] (the early
step's rays x chord-bound samples), [1024, 113] (dense), [37, 1000], and
past the 1024-sample tile at [1024, 1312] (the long-ray early step's
chord-bound K), [1024, 2048] and [256, 8192] (several stages), on
`chip_smoke.py`'s composite inputs (inv_s 20, dist 0.0125; that file is
always this checkout's), L2 warm and flushed, with `chip_smoke.py`'s `_device_profile` (device times by
torch.profiler). Each call goes through the tree's wrappers `composite_fwd`
/ `composite_bwd`, so any tree's C interface is timed alike: `kernel_ms`
sums the device events of the composite kernel the tree launched (the tiled
`composite_fwd_kernel` / `composite_bwd_kernel`, or the kernel it takes past
the tile, whatever its name: `composite_{fwd,bwd}_<name>_kernel`; a call
whose kernel is not among the events raises), `wrapper_ms` and
`wrapper_events` the wrapper's whole call. Forward and backward in turns
(forward, backward, backward, forward). Two trees are compared on the same
card by running this once per tree, in turns (A, B, B, A).

Prints one line per shape and, last, one JSON object of all the times.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import re
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
SHAPES = ((1024, 76), (1024, 113), (37, 1000), (1024, 1312), (1024, 2048), (256, 8192))


def kernel_ms(by_name: dict, direction: str) -> float:
    """Device ms of the composite kernels of `direction` ("fwd" or "bwd")
    among a call's events; raises when there is none."""
    hits = {k: v for k, v in by_name.items() if re.search(rf"composite_{direction}(_\w+)?_kernel", k)}
    if not hits:
        raise AssertionError(f"no composite_{direction} kernel among the device events {sorted(by_name)}")
    return sum(hits.values())


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=str(HERE), help="checkout whose poseprobe_tpu_torch is timed")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("composite_times: no CUDA device", file=sys.stderr)
        return 1
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    from poseprobe_tpu_torch.ops import fused_composite
    if not Path(fused_composite.__file__).resolve().is_relative_to(tree):
        raise AssertionError(f"imported {fused_composite.__file__}, not the package of {tree}")
    cs = _chip_smoke()
    cs._FLUSH[:] = [torch.empty(2 ** 24, device="cuda"), torch.empty(2 ** 24, device="cuda")]
    results = {}
    for N, S in SHAPES:
        inputs, cts = cs._composite_case(N, S, 20.0, 0.0125, seed=N * 7 + S)
        fns = {"fwd": lambda: fused_composite.composite_fwd(*inputs),
               "bwd": lambda: fused_composite.composite_bwd(*inputs, *cts)}
        for flush in (False, True):
            runs = {d: [] for d in fns}
            for d in ("fwd", "bwd", "bwd", "fwd"):
                ms, events, by_name = cs._device_profile(fns[d], flush=flush)
                runs[d].append({"kernel_ms": kernel_ms(by_name, d), "wrapper_ms": ms, "wrapper_events": events})
            key = f"[{N}, {S}], L2 {'flushed' if flush else 'warm'}"
            results[key] = {d: {m: sum(r[m] for r in rs) / len(rs) for m in rs[0]} | {"turns": rs}
                            for d, rs in runs.items()}
            print(f"{key}: device ms (mean of two turns): " + ", ".join(
                f"{d} kernel {v['kernel_ms']:.5f}, wrapper {v['wrapper_ms']:.5f} in {v['wrapper_events']:g} events"
                for d, v in results[key].items()))
    print(json.dumps({"tree": str(tree), "times": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
