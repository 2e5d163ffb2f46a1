"""Compare the machine code of the trunk kernels of fused_trunk.cu in two trees.

    python3 tools/sass_compare.py --tree DIR

Builds `csrc/fused_trunk.cu` of this checkout and of the checkout in DIR
(each with its own `ops/_build.py`, into its own `build/`), disassembles both
libraries with `cuobjdump -sass`, and compares, for the forward, the backward
chain and the dW kernel, the instructions of each instantiation (width 256 or
128, input pad 64 or 128; 256 and 64 is the 8x256 main path) with DIR's
kernel of the same name and template arguments (for a DIR whose kernel is not
a template, its only one, against <256, 64>). The backward chain at width 128
lives in `csrc/trunk_narrow.cu` (`trunk_narrow_chain_kernel<pad>`): where DIR
has fused_trunk.cu's <128, pad> and this checkout has not, that
instantiation is reported as replaced, with the new kernel's instruction
count, not compared. Addresses, encodings and symbol names are left out of
the comparison. Prints one line per kernel and instantiation (its
instruction count and whether the two are identical, or what replaced it)
and, last, one JSON object whose `all_identical` says whether every compared
instantiation was. Needs nvcc and cuobjdump (CUDA toolkit under
/usr/local/cuda, or CUDA_HOME).
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
INSTANCES = {(256, 64): "ILi256ELi64E", (256, 128): "ILi256ELi128E",   # mangled template arguments
             (128, 64): "ILi128ELi64E", (128, 128): "ILi128ELi128E"}
NARROW = "trunk_narrow_chain_kernel"   # csrc/trunk_narrow.cu: the chain at width 128, a template on the pad


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
    compared = [v["identical"] for v in result.values() if "identical" in v]
    print(json.dumps({"kernels": result, "all_identical": bool(compared) and all(compared)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
