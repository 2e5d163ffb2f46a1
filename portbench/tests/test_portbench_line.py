"""A whole run at the tests' size on the CPU: the last line's keys, and the
count of the trunk's calls against the calls the program makes."""
import json

import pytest
import torch

from portbench import manifest, run as run_mod
from portbench.tests import small

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell", ["synthetic_3view.mid", "dtu_generic.render"])
def test_last_line_keys(cell):
    res = run_mod.measure(small.run(cell), manifest.benchmark(), device="cpu")
    assert list(res) == KEYS
    # `correct` is decided on the card: the limits are set from the kernels' readings there
    assert isinstance(res["correct"], bool) and res["attempted"] > 0 and res["failed"] == 0
    e2e, _ = manifest.cell_metrics(manifest.benchmark(), cell)
    assert set(res["metrics"]) == {m["name"] for m in e2e}
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(res["checks"]) == set(manifest.workload(cell)["limits"])
    json.dumps(res)


def test_counted_trunk_calls_match_the_programs(monkeypatch):
    from poseprobe_tpu_torch.models import scene_nerf
    from portbench.drivers import train
    seen, real = [], scene_nerf.nerf_forward

    def watch(mlp, cfg, points, ray, progress):
        seen.append(points.shape[:-1].numel())
        return real(mlp, cfg, points, ray, progress)
    r = small.run("synthetic_3view.mid")
    r.device = torch.device("cpu")
    monkeypatch.setattr(scene_nerf, "nerf_forward", watch)
    w = train.setup(r)
    step = w.trace_work["step"]["trunk_calls"]
    assert seen[:len(step)] == [n for n, _ in step]
