"""The benchmark's arithmetic: the rate over the whole window, the work counted
from the configuration, the idle share from a timeline."""
import time
import types

import pytest

from portbench import manifest, readers, run as run_mod, trace
from portbench.counts import peaks, work

SCENE = {"add_raw_3d": True, "L_3D": 10, "layers_feat": [256] * 8, "skip": [4], "layers_rgb": [128, 3],
         "sample_intvs": 128, "sample_intvs_fine": 128, "fine_sampling": True, "rand_rays": 1024}


def _fake_driver(unit_s: list):
    """A driver whose units of 100 rays take the given seconds in turn."""
    class Window:
        work_per_unit, trace_units, trace_work = 100, 1, {}

        def __init__(self):
            self.i = 0

        def unit(self):
            time.sleep(unit_s[min(self.i, len(unit_s) - 1)])
            self.i += 1

        def tally(self):
            return self.i, 0

        def close(self):
            pass

        def check(self):
            return [{"name": "gap", "value": 0.0, "limit": 1.0}]
    return types.SimpleNamespace(setup=lambda run: Window())


def _rate(monkeypatch, unit_s):
    monkeypatch.setattr(manifest, "driver", lambda kind: _fake_driver(unit_s))
    cell = {"name": "fake.cell", "driver": "fake", "chips": 1, "rate_metric": "train_rays_per_s"}
    bench = {"end_to_end": [{"name": "train_rays_per_s", "unit": "rays/s"}], "per_layer": []}
    r = run_mod.Run(cell=cell, config={}, seed=1, seconds=0.25, trace=False, device=None)
    return run_mod.measure(r, bench, device="cpu")["metrics"]["train_rays_per_s"]["value"]


def test_the_rate_is_over_the_whole_window_and_a_stall_lowers_it(monkeypatch):
    steady = _rate(monkeypatch, [0.02])
    stalled = _rate(monkeypatch, [0.02, 0.2, 0.02])
    assert 100 / 0.02 * 0.6 < steady <= 100 / 0.02 * 1.01
    assert stalled < 0.75 * steady


def test_trunk_work_is_the_reference_count():
    assert work.trunk_macs(SCENE) == 491_264
    ops, nbytes = work.trunk_call_cost(SCENE, 1000, False)
    assert ops == 2 * 491_264 * 1000
    assert work.trunk_call_cost(SCENE, 1000, True)[0] == 2 * ops
    assert peaks.least_seconds(ops, nbytes) == pytest.approx(ops / 989e12)


def test_idle_share_from_overlapping_intervals():
    busy, gaps = trace.union_length([(1, 4), (2, 3), (3, 5), (7, 8), (7.5, 9), (12, 20)], 0, 10)
    assert busy == pytest.approx(4 + 2)
    assert gaps == [(0, 1), (5, 7), (9, 10)]
    host = [("outer", 0, 10), ("aten::copy_", 4.5, 6), ("cudaStreamSynchronize", 9, 10)]
    assert trace.name_gap((5, 7), host) == "aten::copy_"
    assert trace.name_gap((9, 10), host) == "cudaStreamSynchronize"
    ctx = types.SimpleNamespace(trace=trace.Trace(1, 10.0, 6.0, {}, [], []))
    assert readers.idle_pct(ctx) == pytest.approx(40.0)


def test_roofline_and_mfu_shares_from_the_trace_and_the_config():
    call = work.trunk_call_cost(SCENE, 393_216, False)
    least = peaks.least_seconds(*call)
    tr = trace.Trace(1, 1.0, 1.0, {"void trunk_fwd_kernel<256, 64>": 2 * least, "elementwise": 1.0}, [], [])
    run = types.SimpleNamespace(config={"experiment": {"scene_model": SCENE}}, work={"flops": 989e12 * 0.1})
    ctx = types.SimpleNamespace(trace=tr, run=run, trace_work={"bands": 1, "band": {
        "trunk_calls": [(393_216, False)], "lookups": []}}, unprofiled_s=2.0, unprofiled_units=4)
    assert readers.trunk_roofline_pct(ctx) == pytest.approx(50.0)
    assert readers.mfu_pct(ctx) == pytest.approx(20.0)
    assert readers.grid_roofline_pct(ctx) is None


def test_the_mid_step_counts_its_six_trunk_calls():
    cfg = {"scene_model": SCENE, "scene_train": {"depth_regu_patch_size": 2, "loss_weight": [
        ["render", 0.0], ["corres", -2.0], ["depth_cons", -3.0]]}, "_matches": 256}
    calls = work.scene_trunk_calls(cfg, 3, {"fine_on": True, "depth_cons_on": True})
    assert [n for n, _ in calls] == [1532 * 128, 1532 * 256, 256 * 128, 256 * 128, 256 * 128, 256 * 256]
    assert [g for _, g in calls] == [True, True, False, False, True, True]
