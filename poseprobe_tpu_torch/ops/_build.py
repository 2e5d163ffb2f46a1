"""Build and load the port's CUDA kernels: nvcc at first use, ctypes binding.

Every `csrc/<name>.cu` has a plain C interface (`extern "C"` functions that
take raw pointers, ints and the stream, launch on that stream and return
`cudaGetLastError()`), so nvcc compiles it in seconds into
`build/lib<name>.so` and `ctypes` loads it. The first `load` of any library
compiles every source that is out of date (older than its library, it or a
`csrc/` header it includes), all at once (one nvcc process each), under a lock on `build/build.lock`, so that of several processes
starting together one builds and the others load its libraries. Nothing here runs at import: a machine without nvcc or a card can
import every module.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import os
import re
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD = Path(__file__).resolve().parents[1] / "build"
SOURCES = ("fused_composite", "fused_trunk", "layout", "posenc", "trilinear", "trunk_narrow", "trunk_wide")


def build(names=SOURCES, force: bool = False) -> dict:
    """Compile the named csrc/*.cu sources with nvcc (all at once, one process
    each) into build/lib<name>.so, unless an up-to-date library is there (or
    `force`). Returns {name: seconds spent compiling it, 0.0 if up to date}."""
    _BUILD.mkdir(parents=True, exist_ok=True)
    # one process builds while the others wait (ranks of a job start together on a clean
    # tree); a waiter then finds the libraries up to date. The kernel drops the lock of a
    # process that dies.
    with open(_BUILD / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return _build_locked(names, force)


def inputs(name: str) -> list:
    """csrc/<name>.cu and the csrc/ headers it includes (`#include "..."`):
    the files whose changes its library follows."""
    src = _CSRC / f"{name}.cu"
    return [src] + [_CSRC / h for h in re.findall(r'^#include "([^"]+)"', src.read_text(), re.M)]


def _build_locked(names, force: bool) -> dict:
    nvcc = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    procs, started = {}, time.perf_counter()
    for name in names:
        src, lib = _CSRC / f"{name}.cu", _BUILD / f"lib{name}.so"
        if not force and lib.exists() and lib.stat().st_mtime >= max(f.stat().st_mtime for f in inputs(name)):
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [str(nvcc), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, lib)
    seconds = {name: 0.0 for name in names}
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
        (_BUILD / f"lib{name}.ptxas.txt").write_text(log)
        os.replace(tmp, lib)
        seconds[name] = time.perf_counter() - started
    return seconds


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The library of csrc/<name>.cu, built first if needed (with every other
    source that is out of date, so one wait covers them all). The caller sets
    the argtypes of the functions it calls."""
    build()
    lib = ctypes.CDLL(str(_BUILD / f"lib{name}.so"))
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def declare(lib: ctypes.CDLL, **signatures) -> ctypes.CDLL:
    """Set argtypes of the named launch functions from strings of 'p' (pointer
    or stream), 'i' (int) and 'l' (long long); each returns the CUDA error code."""
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_longlong}
    for fn, sig in signatures.items():
        getattr(lib, fn).argtypes = [kinds[c] for c in sig]
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.cuda_error_string(err).decode()}")


def ptr(t):
    return None if t is None else t.data_ptr()
