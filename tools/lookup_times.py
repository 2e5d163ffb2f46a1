"""Device times of a tree's trilinear lookup at captured training-step points.

    python3 tools/lookup_times.py --points FILE [--tree DIR]

FILE comes from `python3 chip_smoke.py --lookup-points FILE`: the points of
every grid lookup of one early step of the bench-scale joint trainer, at its
first step ("early") and after `fit()` ("late"). For each lookup, on a random
grid of its shape (the same seed as `chip_smoke.py`), it times the lookup of
the `poseprobe_tpu_torch` package found in DIR (default: this checkout) and,
as the yardstick common to every tree, `F.grid_sample` and its backward, in
turns, L2 warm and flushed, with `chip_smoke.py`'s `_device_ms` (device times
by torch.profiler; that file is always this checkout's). Forward: the whole
lookup from the [C, X, Y, Z] grid; backward: zero-fill, scatter and whatever
the tree does to return d_grid as [C, X, Y, Z] (d_pts too with the
gradient); for more than one channel also the backward with
POSEPROBE_SCATTER_BARRIER=1. A tree whose lookup reads [V, C] rows (its
`ops.grid` has `rows_from_grid`) is called through that interface, its row
copy in the forward and its `transpose_slice` in the backward. Two trees are
compared on the same card by running this once per tree, back to back, in
turns (A, B, B, A).

Prints one line per lookup and, last, one JSON object of all the times.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _staged(fn):
    """`fn` with POSEPROBE_SCATTER_BARRIER=1 set around it."""
    def call():
        os.environ["POSEPROBE_SCATTER_BARRIER"] = "1"
        try:
            return fn()
        finally:
            os.environ.pop("POSEPROBE_SCATTER_BARRIER")
    return call


def lookup_fns(grid_ops, grid, pts, lo, hi, ct_v, ct_g, with_grad: bool) -> dict:
    """The tree's forward and backward of one lookup, and grid_sample's."""
    gshape, C = tuple(grid.shape), grid.shape[0]
    cg = ct_g if with_grad else None
    if hasattr(grid_ops, "rows_from_grid"):
        rows = grid_ops.rows_from_grid(grid)
        fns = {"fwd": lambda: grid_ops.trilinear_fwd(grid_ops.rows_from_grid(grid), pts, lo, hi, gshape, with_grad),
               "bwd": lambda: grid_ops.trilinear_bwd(rows, pts, lo, hi, gshape, ct_v, cg, True, with_grad)}
    else:
        fns = {"fwd": lambda: grid_ops.trilinear_fwd(grid, pts, lo, hi, with_grad),
               "bwd": lambda: grid_ops.trilinear_bwd(grid, pts, lo, hi, ct_v, cg, True, with_grad)}
    if C > 1:
        fns["bwd_staged"] = _staged(fns["bwd"])
    coords = (2.0 * grid_ops.normalize_coords(pts, lo, hi) - 1.0)[:, [2, 1, 0]].reshape(1, 1, 1, -1, 3).contiguous()
    gl = grid.clone().requires_grad_(True)
    out_l = torch.nn.functional.grid_sample(gl[None], coords, mode="bilinear", padding_mode="border", align_corners=True)
    ct_l = ct_v.t().reshape(1, C, 1, 1, -1).contiguous()
    fns["lib_fwd"] = lambda: torch.nn.functional.grid_sample(grid[None], coords, mode="bilinear",
                                                             padding_mode="border", align_corners=True)
    fns["lib_bwd"] = lambda: torch.autograd.grad(out_l, gl, ct_l, retain_graph=True)
    return fns


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--points", required=True, help="lookup points saved by chip_smoke.py --lookup-points")
    parser.add_argument("--tree", default=str(HERE), help="checkout whose poseprobe_tpu_torch is timed")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("lookup_times: no CUDA device", file=sys.stderr)
        return 1
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    from poseprobe_tpu_torch.ops import grid as grid_ops
    if not Path(grid_ops.__file__).resolve().is_relative_to(tree):
        raise AssertionError(f"imported {grid_ops.__file__}, not the package of {tree}")
    cs = _chip_smoke()
    cs._FLUSH[:] = [torch.empty(2 ** 24, device="cuda"), torch.empty(2 ** 24, device="cuda")]
    captured = torch.load(args.points)
    results = {}
    for label, sets in captured.items():
        for i, (gs, with_grad, p, lo, hi) in enumerate(sets):
            C = gs[0]
            g = torch.Generator(device="cuda").manual_seed(C)
            grid = torch.randn(gs, generator=g, device="cuda")
            ct_v = torch.randn((p.shape[0], C), generator=g, device="cuda")
            ct_g = torch.randn((p.shape[0], C, 3), generator=g, device="cuda")
            p, lo, hi = p.cuda(), lo.cuda(), hi.cuda()
            fns = lookup_fns(grid_ops, grid, p, lo, hi, ct_v, ct_g, with_grad)
            for flush in (False, True):
                t = {k: [] for k in fns}
                for order in (list(fns), list(fns)[::-1]):
                    for k in order:
                        t[k].append(cs._device_ms(fns[k], flush=flush))
                key = f"{label} lookup {i}, L2 {'flushed' if flush else 'warm'}"
                results[key] = {k: sum(v) / 2 for k, v in t.items()} | {k + "_turns": v for k, v in t.items()}
                print(f"{key}: grid {list(gs)}{' value+grad' if with_grad else ''}, N={p.shape[0]}, device ms "
                      "(mean of two turns): " + ", ".join(f"{k} {sum(v) / 2:.4f}" for k, v in t.items()))
    print(json.dumps({"tree": str(tree), "times": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
