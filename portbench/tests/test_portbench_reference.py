"""The plain reference against the port at the tests' size on the CPU, and a
run whose timed path is broken underneath coming out not correct."""
import copy

import pytest
import torch

from portbench import guard, manifest, run as run_mod
from portbench.tests import small


def _window(cell):
    r = small.run(cell)
    r.device = torch.device("cpu")
    w = manifest.driver(r.cell["driver"]).setup(r)
    if r.cell["driver"] == "render":
        while w.n <= max(w.sampled):
            w.unit()
    w.close()
    return w


@pytest.mark.parametrize("cell", ["synthetic_3view.mid", "synthetic_3view.early", "dtu_generic.render"])
def test_the_reference_follows_the_port(cell):
    # on the CPU the program runs its plain paths (the bfloat16 products rounded twice), so its
    # gaps are of bfloat16's size; the control's, of float8's, stand well above them
    w = _window(cell)
    limits = w.run.cell["limits"]

    def worst(gaps):
        return max(gaps[k] / v for k, v in limits.items())
    prog, control = w.readings("program"), w.readings("control")
    assert worst(prog) < 10, prog
    assert worst(control) > 2 * worst(prog), (prog, control)


def test_the_half_batch_fault_reads_far_above_the_program():
    w = _window("synthetic_3view.early")
    gaps = w.readings("half_batch")
    assert all(gaps[k] > v for k, v in w.run.cell["limits"].items()), gaps


def _half_scene_batch(monkeypatch):
    from poseprobe_tpu_torch.losses import scene
    real = scene.photometric_and_regu_loss

    def half(render_out, target, opt, *a, **k):
        n = target.shape[1] // 2 // 4 * 4
        return real({key: v[:, :n] for key, v in render_out.items()}, target[:, :n], opt, *a, **k)
    monkeypatch.setattr(scene, "photometric_and_regu_loss", half)


def _unchanged_state(monkeypatch):
    from poseprobe_tpu_torch.train import optim

    def nothing(self, grads, state):
        from poseprobe_tpu_torch.core.tree import tree_leaves
        return [torch.zeros_like(g) for g in tree_leaves(grads)]
    monkeypatch.setattr(optim._Adam, "_direction", nothing)


def _loss_altered(monkeypatch):
    from poseprobe_tpu_torch.losses import common
    real = common.summarize_losses
    monkeypatch.setattr(common, "summarize_losses", lambda *a, **k: 1.05 * real(*a, **k))


def _render_altered(monkeypatch):
    from poseprobe_tpu_torch.models import scene_nerf
    real = scene_nerf.render_rays

    def altered(*a, **k):
        out = real(*a, **k)
        out["rgb_fine"] = out["rgb_fine"] + 0.05
        return out
    monkeypatch.setattr(scene_nerf, "render_rays", altered)


@pytest.mark.parametrize("cell,fault", [("synthetic_3view.mid", _unchanged_state),
                                        ("synthetic_3view.mid", _half_scene_batch),
                                        ("synthetic_3view.early", _loss_altered),
                                        ("dtu_generic.render", _render_altered)])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    res = run_mod.measure(small.run(cell), manifest.benchmark(), device="cpu")
    assert res["correct"] is False, res["checks"]


def test_the_guard_refuses_a_config_the_port_does_not_build():
    conf = manifest.config("dtu_generic")
    assert guard.check(conf).scene_model.sample_intvs == 128
    bad = copy.deepcopy(conf)
    bad["experiment"]["scene_model"]["sample_intvs"] = 64
    with pytest.raises(guard.ConfigMismatch, match="scene_model.sample_intvs"):
        guard.check(bad)
