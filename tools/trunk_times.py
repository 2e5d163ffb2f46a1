"""Device times of a tree's trunk kernels at the mid step's fine render.

    python3 tools/trunk_times.py [--tree DIR] [--width 128|256|512] [--l3d L] [--records]

Times the trunk forward (with and without stored activations) and backward
of the `poseprobe_tpu_torch` package found in DIR (default: this checkout)
at the mid step's fine render, 393,216 points of the 8x256 trunk with a
63-wide encoding (padded to 64), through the tree's wrappers `trunk_fwd` /
`trunk_bwd`, with `chip_smoke.py`'s `_device_profile` (device times by
torch.profiler; that file is always this checkout's), L2 warm, in turns
(forward, backward, backward, forward). `kernel_ms` sums the device events
whose name holds `trunk_`, `wrapper_ms` every device event of the call (the
backward's zero-fill of dW and db included). With `--width 512` the trunk is
the wide cell's, 8x512 at L_3D 10 (the same 63-wide encoding; the kernels of
`csrc/trunk_wide.cu`), and the backward's chain and dW are also timed apart
(`bwd_chain`, `bwd_dw`: the tree's `_bwd_launch` on buffers made once; the
chain's time includes its seed kernel). With `--width 128` it is the narrow
cell's 8x128 trunk at L_3D 16 (a 99-wide encoding padded to 128; `--l3d 10`
gives the 63-wide one padded to 64), with the chain and dW also apart. The
encoding is padded with the tree's `fused_mlp.in_pad`. Two trees are
compared on the same card by running this once per tree, in turns (A, B, B,
A). `--records` also prints `chip_smoke.py`'s kernel records of this trunk
(`_trunk_records`: the plain twin's time, the bound, the library's products),
for a tree whose `fused_mlp` is this checkout's.

Prints one line per call and, last, one JSON object of all the times.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
POINTS = (1024 + 2 * 256) * 256        # chip_smoke.FINE_POINTS


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=str(HERE), help="checkout whose poseprobe_tpu_torch is timed")
    parser.add_argument("--width", type=int, default=256, choices=(128, 256, 512),
                        help="the trunk's width: 256 (the main path), 128 (the narrow cell) or 512 (the wide cell)")
    parser.add_argument("--l3d", type=int, default=None,
                        help="the encoding's L_3D (default: 16 at width 128, else 10)")
    parser.add_argument("--records", action="store_true", help="also print chip_smoke.py's kernel records")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("trunk_times: no CUDA device", file=sys.stderr)
        return 1
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    from poseprobe_tpu_torch.models import scene_nerf
    from poseprobe_tpu_torch.ops import fused_mlp, pe
    if not Path(fused_mlp.__file__).resolve().is_relative_to(tree):
        raise AssertionError(f"imported {fused_mlp.__file__}, not the package of {tree}")
    cs = _chip_smoke()
    l3d = args.l3d if args.l3d is not None else (16 if args.width == 128 else 10)
    cfg = scene_nerf.SceneConfig(layers_feat=(args.width,) * 8, L_3D=l3d)
    L, skip = len(cfg.layers_feat), cfg.skip[0]
    mlp = scene_nerf.init_nerf_mlp(torch.Generator().manual_seed(0), cfg)
    w, b = fused_mlp.pack_params([{k: v.cuda() for k, v in la.items()} for la in mlp["feat"]], skip)
    g = torch.Generator(device="cuda").manual_seed(POINTS)
    points = torch.rand((POINTS, 3), generator=g, device="cuda") * 6.0 - 3.0
    enc = pe.posenc_scene(points, cfg.L_3D, 1.0, cfg.barf_c2f).to(torch.bfloat16)
    enc = torch.nn.functional.pad(enc, (0, fused_mlp.in_pad(enc.shape[1]) - enc.shape[1])).contiguous()
    feat, _, acts = fused_mlp.trunk_fwd(enc, w, b, L, skip)
    g_feat = (torch.randn(feat.shape, generator=g, device="cuda") * 1e-3).to(torch.bfloat16)
    g_dens = (torch.randn(POINTS, generator=g, device="cuda") * 1e-3).to(torch.bfloat16)
    fns = {"fwd": lambda: fused_mlp.trunk_fwd(enc, w, b, L, skip),
           "fwd_no_acts": lambda: fused_mlp.trunk_fwd(enc, w, b, L, skip, store_acts=False),
           "bwd": lambda: fused_mlp.trunk_bwd(enc, g_feat, g_dens, feat, acts, w, b, L, skip)}
    order = ["fwd", "fwd_no_acts", "bwd", "bwd", "fwd_no_acts", "fwd"]
    if args.width != 256:
        out = fused_mlp._bwd_outputs(POINTS, w, b, L, enc.shape[1])
        for part in ("chain", "dw"):
            fns[f"bwd_{part}"] = functools.partial(fused_mlp._bwd_launch, enc, g_feat, g_dens, feat, acts, w, out, L,
                                                   skip, (part,))
        order[3:3] = ["bwd_chain", "bwd_dw", "bwd_dw", "bwd_chain"]
    runs = {d: [] for d in fns}
    for d in order:
        ms, events, by_name = cs._device_profile(fns[d], iters=10)
        kernel = sum(v for k, v in by_name.items() if "trunk_" in k)
        runs[d].append({"kernel_ms": kernel, "wrapper_ms": ms, "wrapper_events": events})
    results = {d: {m: sum(r[m] for r in rs) / len(rs) for m in rs[0]} | {"turns": rs} for d, rs in runs.items()}
    for d, v in results.items():
        print(f"trunk {d} at {POINTS} points, {args.width}x{L}, input pad {enc.shape[1]}: kernel {v['kernel_ms']:.4f} ms (turns "
              f"{[round(r['kernel_ms'], 4) for r in v['turns']]}), wrapper {v['wrapper_ms']:.4f} in "
              f"{v['wrapper_events']:g} events")
    if args.records:
        recs = cs._trunk_records(fused_mlp, cfg, enc, w, b, L, skip, g_feat, g_dens, feat, acts, 0.0, 0.0)
        print(json.dumps({k: {m: r[m] for m in ("name", "ms", "plain_ms", "bound_ms", "bound_by")} for k, r in recs.items()}))
    print(json.dumps({"tree": str(tree), "width": args.width, "L_3D": l3d, "pad": enc.shape[1], "times": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
