"""The configuration guard: the port must build, from its own preset or
workload builder, exactly the `ExperimentConfig` the configuration file
holds; the run refuses to start on any difference. So a later edit to a port
preset or builder cannot move the yardstick unseen."""
from __future__ import annotations

import dataclasses
import importlib
import json


class ConfigMismatch(RuntimeError):
    pass


def plain(cfg) -> dict:
    """An `ExperimentConfig` as the JSON values the configuration file holds."""
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def differences(a, b, path: str = "") -> list:
    if isinstance(a, dict) and isinstance(b, dict):
        return [d for k in sorted(set(a) | set(b)) for d in differences(a.get(k), b.get(k), f"{path}.{k}")]
    return [] if a == b else [f"{path.lstrip('.')}: port {a!r}, file {b!r}"]


def check(conf: dict):
    """Build the port's config with the file's builder; raise ConfigMismatch
    if it differs from the file's `experiment`. Returns the port's config."""
    b = conf["port_builder"]
    out = getattr(importlib.import_module(b["module"]), b["function"])(**b.get("kwargs", {}))
    cfg = out[0] if isinstance(out, tuple) else out
    diff = differences(plain(cfg), conf["experiment"])
    if diff:
        raise ConfigMismatch(f"the port's {b['module']}.{b['function']} builds another config than "
                             f"{conf['name']}.json: " + "; ".join(diff[:10]))
    return cfg
