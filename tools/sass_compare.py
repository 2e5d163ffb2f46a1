"""Compare the machine code of the trunk and composite kernels in two trees.

    python3 tools/sass_compare.py --tree DIR

Builds `csrc/fused_trunk.cu` and `csrc/fused_composite.cu` of this checkout
and of the checkout in DIR (each with its own `ops/_build.py`, into its own
`build/`), disassembles the libraries with `cuobjdump -sass`, and compares
the instructions of each kernel instantiation with DIR's kernel of the same
name and template arguments:
* the trunk's forward, backward chain and dW kernel at width 256 or 128 and
  input pad 64 or 128 (256 and 64 is the 8x256 main path; for a DIR whose
  kernel is not a template, its only one, against <256, 64>). The backward
  chain at width 128 lives in `csrc/trunk_narrow.cu`
  (`trunk_narrow_chain_kernel<pad>`): where DIR has fused_trunk.cu's
  <128, pad> and this checkout has not, that instantiation is reported as
  replaced, with the new kernel's instruction count, not compared;
* the kernels of the trunk's checkpoint strides other than 1, the forward
  that stores every k-th layer (`trunk_fwd_ckpt_kernel`) and the remat
  (`trunk_remat_kernel`), at the same four instantiations: compared where
  DIR has them, else listed as new with their instruction counts;
* the composite's tiled forward and backward (`composite_fwd_kernel`,
  `composite_bwd_kernel`), each with runs in registers (<5>) and in shared
  memory (<0>). Past the tile DIR's kernels that this checkout no longer has
  (the chunked kernels, `composite_{fwd,bwd}_chunked_kernel`) are reported as
  replaced by this checkout's kernel of that direction past the tile
  (`composite_{fwd,bwd}_ray_kernel`), with both instruction counts.
Addresses, encodings and symbol names are left out of the comparison. Prints
one line per kernel and instantiation (its instruction count and whether the
two are identical, or what replaced it) and, last, one JSON object whose
`all_identical` says whether every compared instantiation was. Needs nvcc and
cuobjdump (CUDA toolkit under /usr/local/cuda, or CUDA_HOME).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
KERNELS = ("trunk_fwd_kernel", "trunk_bwd_chain_kernel", "trunk_bwd_dw_kernel")
STRIDE_KERNELS = ("trunk_fwd_ckpt_kernel", "trunk_remat_kernel")   # checkpoint strides other than 1
INSTANCES = {(256, 64): "ILi256ELi64E", (256, 128): "ILi256ELi128E",   # mangled template arguments
             (128, 64): "ILi128ELi64E", (128, 128): "ILi128ELi128E"}
NARROW = "trunk_narrow_chain_kernel"   # csrc/trunk_narrow.cu: the chain at width 128, a template on the pad
COMPOSITE = ("composite_fwd_kernel", "composite_bwd_kernel")   # the tiled kernels, templates on the run registers
COMPOSITE_INSTANCES = {5: "ILi5E", 0: "ILi0E"}
# past the tile: DIR's kernel -> this checkout's kernel of that direction
COMPOSITE_PAST_TILE = {"composite_fwd_chunked_kernel": "composite_fwd_ray_kernel",
                       "composite_bwd_chunked_kernel": "composite_bwd_ray_kernel"}


def _library(tree: Path, name: str = "fused_trunk") -> Path:
    subprocess.run([sys.executable, "-c", f"from poseprobe_tpu_torch.ops import _build; _build.build(['{name}'])"],
                   cwd=tree, check=True)
    return tree / "poseprobe_tpu_torch" / "build" / f"lib{name}.so"


def _functions(lib: Path) -> dict:
    """{mangled name: [instruction text]} of every kernel in `lib`."""
    cuobjdump = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if m and cur is not None:
            cur.append(re.sub(r"`\([^)]*\)", "`()", m.group(1)))   # symbol references by name
    return out


def _pick(funcs: dict, kernel: str, instance: str, only_ok: bool):
    """The instructions of `kernel`<instance> in `funcs`; with `only_ok`, a
    tree's only kernel of that name when it has no instantiations; None when
    absent."""
    names = [k for k in funcs if kernel in k]
    picked = [k for k in names if instance in k]
    if not picked and only_ok and len(names) == 1:
        picked = names
    if len(picked) > 1:
        raise AssertionError(f"{kernel}{instance}: expected one kernel, found {picked}")
    return funcs[picked[0]] if picked else None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", required=True, help="the other checkout")
    args = parser.parse_args(argv)
    ours, theirs = _functions(_library(HERE)), _functions(_library(Path(args.tree).resolve()))
    narrow = _functions(_library(HERE, "trunk_narrow"))
    result = {}
    for kernel in KERNELS:
        for (H, kin), instance in INSTANCES.items():
            a = _pick(ours, kernel, instance, False)
            b = _pick(theirs, kernel, instance, (H, kin) == (256, 64))
            name = f"{kernel}<{H}, {kin}>"
            if a is None and b is not None and kernel == "trunk_bwd_chain_kernel" and H == 128:
                new = _pick(narrow, NARROW, f"ILi{kin}E", False)
                result[name] = {"replaced_by": f"{NARROW}<{kin}>", "instructions": len(new or []),
                                "other_instructions": len(b)}
                print(f"{name}: replaced by {NARROW}<{kin}> ({len(new or [])} instructions), {args.tree}: {len(b)}")
                continue
            if a is None or b is None:
                continue
            result[name] = {"instructions": len(a), "other_instructions": len(b), "identical": a == b}
            print(f"{name}: {len(a)} instructions, {args.tree}: {len(b)}; {'identical' if a == b else 'different'}")
    for kernel in STRIDE_KERNELS:
        for (H, kin), instance in INSTANCES.items():
            a, b = _pick(ours, kernel, instance, False), _pick(theirs, kernel, instance, False)
            name = f"{kernel}<{H}, {kin}>"
            if a is None:
                raise AssertionError(f"{name}: missing in this checkout")
            if b is None:
                result[name] = {"new": True, "instructions": len(a)}
                print(f"{name}: {len(a)} instructions, new (not in {args.tree})")
                continue
            result[name] = {"instructions": len(a), "other_instructions": len(b), "identical": a == b}
            print(f"{name}: {len(a)} instructions, {args.tree}: {len(b)}; {'identical' if a == b else 'different'}")
    ours_c = _functions(_library(HERE, "fused_composite"))
    theirs_c = _functions(_library(Path(args.tree).resolve(), "fused_composite"))
    for kernel in COMPOSITE:
        for regs, instance in COMPOSITE_INSTANCES.items():
            a, b = _pick(ours_c, kernel, instance, False), _pick(theirs_c, kernel, instance, False)
            name = f"{kernel}<{regs}>"
            if a is None or b is None:
                raise AssertionError(f"{name}: missing in {'this checkout' if a is None else args.tree}")
            result[name] = {"instructions": len(a), "other_instructions": len(b), "identical": a == b}
            print(f"{name}: {len(a)} instructions, {args.tree}: {len(b)}; {'identical' if a == b else 'different'}")
    for old, new in COMPOSITE_PAST_TILE.items():
        a, b = _pick(ours_c, old, "", False), _pick(theirs_c, old, "", False)
        if b is None:
            continue
        if a is not None:
            result[old] = {"instructions": len(a), "other_instructions": len(b), "identical": a == b}
            print(f"{old}: {len(a)} instructions, {args.tree}: {len(b)}; {'identical' if a == b else 'different'}")
            continue
        n_new = len(_pick(ours_c, new, "", False) or [])
        result[old] = {"replaced_by": new, "instructions": n_new, "other_instructions": len(b)}
        print(f"{old}: replaced by {new} ({n_new} instructions), {args.tree}: {len(b)}")
    compared = [v["identical"] for v in result.values() if "identical" in v]
    print(json.dumps({"kernels": result, "all_identical": bool(compared) and all(compared)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
