"""`spans.py`'s attribution on hand-built event lists, the readers of the span
metrics where there is nothing to read, and the span stretch of a small cell
on the CPU (its profile stubbed: a CPU trace has no device events)."""
import dataclasses

import pytest
import torch

from portbench import manifest, spans
from portbench.spans import NO_SPAN, OUTSIDE, UNLINKED, Op
from portbench.tests import small

SPAN_METRICS = ["scene_render_plain_ms.train", "scene_render_plain_ms.render", "object_render_ms_per_step",
                "losses_ms_per_step", "optimizer_ms_per_step", "maskcache_fill_pct", "host_wait_ms.render"]
ENGINE = "autograd::engine::evaluate_function: MulBackward0"


def _approx(d: dict) -> dict:
    return {k: pytest.approx(v, abs=1e-12) for k, v in d.items()}


def test_a_kernel_goes_to_the_innermost_span_of_its_launch():
    ops = [Op("poseprobe.step.batch", 1, 0, 100), Op("poseprobe.scene.trunk", 1, 10, 50),
           Op("aten::mm", 1, 20, 30, kernels=(("gemm", 1e-3),)),
           Op("aten::add", 1, 60, 70, kernels=(("add", 2e-3),)),
           Op("aten::fill_", 1, 110, 120, kernels=(("fill", 3e-3),)),
           Op("aten::copy_", 2, 20, 30, kernels=(("copy", 5e-4),))]      # another thread: no span there
    device = [("gemm", 200, 1200), ("add", 1300, 3300), ("fill", 3300, 6300), ("copy", 6300, 6800),
              ("orphan", 7000, 11000)]
    got = spans.attribute(ops, device, 0, 12000)
    assert got["device_s"] == _approx({"poseprobe.scene.trunk": 1e-3, "poseprobe.step.batch": 2e-3,
                                       OUTSIDE: 3e-3 + 5e-4, UNLINKED: 4e-3})
    assert got["total_s"] == pytest.approx(sum(got["device_s"].values()))


def test_a_backward_goes_to_the_span_of_its_forward_op():
    """The engine's op (another thread, or the step's thread inside the
    backward's span) carries the forward's sequence number and thread; of the
    forward ops that recorded that number, the last made the node."""
    fwd = [Op("poseprobe.step.batch", 1, -100, -50), Op("aten::zeros", 1, -90, -80, seq=7),
           Op("poseprobe.object.field", 1, 0, 50), Op("aten::mul", 1, 10, 20, seq=7, kernels=(("mul", 1e-3),)),
           Op("poseprobe.step.backward", 1, 100, 400)]
    device = [("mul", 500, 1500), ("mul_bwd", 1500, 3500), ("sum_bwd", 3500, 4000)]
    on_engine_thread = fwd + [Op(ENGINE, 2, 110, 200, seq=7, fwd_thread=1),
                              Op("aten::mul", 2, 120, 130, kernels=(("mul_bwd", 2e-3),)),
                              Op(ENGINE, 2, 210, 300, seq=9, fwd_thread=1, kernels=(("sum_bwd", 5e-4),))]
    on_step_thread = fwd + [Op(ENGINE, 1, 110, 200, seq=7, fwd_thread=1),
                            Op("aten::mul", 1, 120, 130, kernels=(("mul_bwd", 2e-3),)),
                            Op(ENGINE, 1, 210, 300, seq=9, fwd_thread=1, kernels=(("sum_bwd", 5e-4),))]
    # sequence number 9 has no forward op in the trace: its launch stays where it ran
    got = spans.attribute(on_engine_thread, device, 0, 5000)["device_s"]
    assert got == _approx({"poseprobe.object.field": 3e-3, OUTSIDE: 5e-4, UNLINKED: 0.0})
    got = spans.attribute(on_step_thread, device, 0, 5000)["device_s"]
    assert got == _approx({"poseprobe.object.field": 3e-3, "poseprobe.step.backward": 5e-4, UNLINKED: 0.0})


def test_idle_gaps_go_to_the_span_open_at_their_start():
    ops = [Op("poseprobe.render.chunk", 1, 0, 1000), Op("poseprobe.scene.sample", 1, 100, 300),
           Op("poseprobe.render.chunk", 1, 1000, 2000)]
    device = [("a", 0, 150), ("b", 250, 1200), ("c", 1500, 1800), ("d", 2100, 2200)]
    got = spans.attribute(ops, device, 0, 2500)
    # gaps: [150, 250) in the sample span, [1200, 1500) and [1800, 2100) in the second chunk,
    # [2200, 2500) after every span
    assert got["idle_s"] == _approx({"poseprobe.scene.sample": 1e-4, "poseprobe.render.chunk": 6e-4,
                                     NO_SPAN: 3e-4})
    assert got["busy_s"] == pytest.approx(1.5e-3)


def _ctx(cell):
    return type("Ctx", (), {"run": small.run(cell)})()


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_the_span_readers_find_nothing_without_spans(metric, monkeypatch):
    reader = manifest.reader(metric)
    monkeypatch.setattr(spans, "of", lambda ctx: None)
    assert reader.read(_ctx("synthetic_3view.mid")) is None
    # spans of another layer only, and no counter
    only_trunk = spans.Spans(per="step", units=2, total_ms=1.0, device_ms={"poseprobe.scene.trunk": 1.0},
                             idle_ms={NO_SPAN: 0.1}, values={})
    monkeypatch.setattr(spans, "of", lambda ctx: only_trunk)
    assert reader.read(_ctx("synthetic_3view.mid")) is None


def test_a_program_without_spans_is_not_profiled(monkeypatch):
    from poseprobe_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "span")
    monkeypatch.setattr(manifest, "driver", lambda kind: pytest.fail("a window was built"))
    assert spans._measure(_ctx("synthetic_3view.early")) is None


@pytest.mark.parametrize("cell", ["synthetic_3view.early", "dtu_generic.render"])
def test_the_span_stretch_of_a_small_cell(cell, monkeypatch):
    """The window is built again from the cell's files, its unit is the cell's
    eager steps or band (a training cell's replay unit first, for its idle
    gaps), the mask cache's fill is read from those steps, and the window is
    closed."""
    seen = {"calls": 0}

    def fake_profile(unit, n):
        for _ in range(n + 1):
            unit()
        seen["n"] = n
        seen["calls"] += 1
        return {"device_s": {"poseprobe.step.optimizer": 2e-3, "poseprobe.scene.head": 1e-3, UNLINKED: 0.0},
                "idle_s": {"poseprobe.render.chunk": 4e-4}, "total_s": 3e-3, "busy_s": 3e-3}
    monkeypatch.setattr(spans, "profile", fake_profile)
    r = dataclasses.replace(small.run(cell), trace=True, device=torch.device("cpu"))
    ctx = type("Ctx", (), {"run": r})()
    sp = spans.of(ctx)
    assert spans.of(ctx) is sp                     # once per run
    n = r.cell["trace_units"]
    assert seen["n"] == n and r.spans == {} and r.values == {}
    if cell == "dtu_generic.render":
        assert (sp.per, sp.units, sp.values, sp.replay_idle_ms, seen["calls"]) == ("band", n, {}, {}, 1)
        assert manifest.reader("host_wait_ms.render").read(ctx) == pytest.approx(0.4 / n)
    else:
        assert (sp.per, sp.units, seen["calls"]) == ("step", n * spans.SPAN_STEPS, 2)
        assert sp.replay_idle_ms == _approx({"poseprobe.render.chunk": 0.4 / (n * r.cell["trace_steps"])})
        assert 0 < sp.values["maskcache_fill"] <= 1
        assert manifest.reader("maskcache_fill_pct").read(ctx) == pytest.approx(100 * sp.values["maskcache_fill"])
        assert manifest.reader("optimizer_ms_per_step").read(ctx) == pytest.approx(2.0 / sp.units)
        assert manifest.reader("scene_render_plain_ms.train").read(ctx) == pytest.approx(1.0 / sp.units)
        assert manifest.reader("object_render_ms_per_step").read(ctx) is None
