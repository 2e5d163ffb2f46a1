"""Where the benchmark finds each of its parts, by the name `BENCHMARK.json`
or a cell's file gives it: a cell in `workloads/<cell>.json`, a configuration
in `configs/<config>.json`, a window driver in `drivers/<kind>.py`, a
per-layer metric's reader in `metrics/<metric>.py`. A new cell,
configuration, driver or metric is a new file; no file here names them."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def workload(name: str) -> dict:
    return json.loads((HERE / "workloads" / f"{name}.json").read_text())


def config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no file {path.relative_to(ROOT)} for {name!r}")
    spec = importlib.util.spec_from_file_location(f"portbench._found.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str):
    return _module(HERE / "drivers" / f"{kind}.py", kind)


def reader(metric: str):
    return _module(HERE / "metrics" / f"{metric}.py", metric)


def cell_metrics(bench: dict, cell: str) -> tuple[list, list]:
    """The end-to-end and per-layer metric entries this cell reports."""
    def mine(m):
        return cell in m.get("workloads", [cell])
    e2e = [m for m in bench["end_to_end"] if mine(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if m["moves"] in names and mine(m)]
    return e2e, per_layer
