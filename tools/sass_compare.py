"""Compare the machine code of the 8x256 trunk kernels of two trees.

    python3 tools/sass_compare.py --tree DIR

Builds `csrc/fused_trunk.cu` of this checkout and of the checkout in DIR
(each with its own `ops/_build.py`, into its own `build/`), disassembles both
libraries with `cuobjdump -sass`, and compares, for the forward, the backward
chain and the dW kernel, the instructions of this checkout's instantiation
for width 256 and input pad 64 with DIR's kernel of the same name (DIR's
only one, or its instantiation for the same template arguments). Addresses,
encodings and symbol names are left out of the comparison. Prints one line
per kernel (its instruction count and whether the two are identical) and,
last, one JSON object. Needs nvcc and cuobjdump (CUDA toolkit under
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
INSTANCE = "ILi256ELi64E"               # the mangled template arguments <256, 64>


def _library(tree: Path) -> Path:
    subprocess.run([sys.executable, "-c", "from poseprobe_tpu_torch.ops import _build; _build.build(['fused_trunk'])"],
                   cwd=tree, check=True)
    return tree / "poseprobe_tpu_torch" / "build" / "libfused_trunk.so"


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


def _pick(funcs: dict, kernel: str) -> list:
    names = [k for k in funcs if kernel in k]
    if len(names) > 1:
        names = [k for k in names if INSTANCE in k]
    if len(names) != 1:
        raise AssertionError(f"{kernel}: expected one kernel, found {names}")
    return funcs[names[0]]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", required=True, help="the other checkout")
    args = parser.parse_args(argv)
    ours, theirs = _functions(_library(HERE)), _functions(_library(Path(args.tree).resolve()))
    result = {}
    for kernel in KERNELS:
        a, b = _pick(ours, kernel), _pick(theirs, kernel)
        result[kernel] = {"instructions": len(a), "other_instructions": len(b), "identical": a == b}
        print(f"{kernel}<256, 64>: {len(a)} instructions, {args.tree}: {len(b)}; "
              f"{'identical' if a == b else 'different'}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
