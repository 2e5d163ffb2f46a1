"""A cell at the CPU tests' size: the same files, with the configuration's
sizes cut (64x64 views, a 24^3 grid, 256 rays, 32 + 32 samples; a render of
48-pixel rows in bands of 8 at 16 + 16 samples) and the guard's builder
asked for the same."""
from __future__ import annotations

import copy

from portbench import manifest
from portbench.guard import plain
from portbench.run import Run


def cell(name: str) -> tuple[dict, dict]:
    w, c = copy.deepcopy(manifest.workload(name)), copy.deepcopy(manifest.config(manifest.workload(name)["config"]))
    if w["driver"] == "train":
        from poseprobe_tpu_torch.train.trainer import _bench_workload
        c["port_builder"]["kwargs"]["small"] = True
        c["scene"].update(H=64, W=64, n_matches=64)
        c["experiment"] = plain(_bench_workload(True, "bfloat16")[0])
        w.update(superstep=3, trace_steps=2)
    else:
        c["scene"].update(H=40, W=48)
        c["experiment"]["scene_model"].update(sample_intvs=16, sample_intvs_fine=16)
        c["port_builder"] = {"module": "portbench.tests.small_preset", "function": "get_config", "kwargs": {}}
        w.update(band_rows=8, checked_within=3)
    return w, c


def run(name: str, seed: int = 2 ** 31 + 11, seconds: float = 0.3) -> Run:
    w, c = cell(name)
    return Run(cell=w, config=c, seed=seed, seconds=seconds, trace=False, device=None)
