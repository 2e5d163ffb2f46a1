"""The port's spans (`utils/profiling.span`) and the step's `maskcache_fill`.

With no profiler running `span` is one shared no-op context; under a CPU
`torch.profiler` an eager step emits each of its `poseprobe.step.*` spans as
often as the step's branches run them, the scene render's spans once per
network pass, and the nesting the attribution relies on (a trunk inside a
scene render inside the step; the depth-consistency render inside its loss
span). `render_full` emits one `poseprobe.render.chunk` per chunk. The
`maskcache_fill` metric equals the in-mask lanes counted by hand from the
compaction of the same draws. The file imports no JAX.
"""
import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from poseprobe_tpu_torch.eval import evaluator
from poseprobe_tpu_torch.models import object_sdf, pose_refine, scene_nerf
from poseprobe_tpu_torch.ops import maskcache, ray_sampling
from poseprobe_tpu_torch.train import batching
from poseprobe_tpu_torch.train.trainer import build_scene_trainer, build_trainer
from poseprobe_tpu_torch.utils import profiling

torch.set_num_threads(1)


def _spans(prof) -> list:
    return [e for e in prof.events() if e.name.startswith("poseprobe.")
            and e.device_type == torch.autograd.DeviceType.CPU]


def _inside(inner, outer) -> bool:
    return (inner.thread == outer.thread and outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def _count_calls(monkeypatch, module, name) -> list:
    calls, real = [], getattr(module, name)

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(module, name, counted)
    return calls


def test_span_is_a_shared_no_op_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("poseprobe.a") is profiling.span("poseprobe.b") is profiling.NO_SPAN
    with profiling.span("poseprobe.a"), profiling.span("poseprobe.a"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("poseprobe.test.part"):
            torch.ones(3).sum()
    assert [e.name for e in _spans(prof)] == ["poseprobe.test.part"]


def test_early_step_emits_its_spans(monkeypatch):
    """The small joint trainer's step 1 (object branch, projection term, mask
    cache; coarse scene render only): each step span as often as its branch
    runs, each scene span once for the one render_rays call and its one
    network pass."""
    tr = build_trainer(small=True, device="cpu")
    tr.global_step = 1
    tr.step()
    renders = _count_calls(monkeypatch, scene_nerf, "render_rays")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.step()
    spans = _spans(prof)
    got = collections.Counter(e.name for e in spans)
    assert len(renders) == 1
    step = {"draws": 1, "batch": 2, "scene_losses": 2, "object_losses": 1, "projection": 1,
            "backward": 1, "optimizer": 1}                # scene and object batch; losses and their sum
    assert {k[len("poseprobe.step."):]: v for k, v in got.items() if k.startswith("poseprobe.step.")} == step
    assert {k: v for k, v in got.items() if k.startswith("poseprobe.scene.")} == {
        f"poseprobe.scene.{p}": 1 for p in ("sample", "encode", "trunk", "head", "composite")}
    assert got["poseprobe.host.eager_step"] == 1
    assert got["poseprobe.object.sample"] == 2 and got["poseprobe.object.color"] == 1   # render + projection
    outer = [e for e in spans if e.name == "poseprobe.host.eager_step"][0]
    assert all(_inside(e, outer) for e in spans if e is not outer)
    # the spans of the step's parts do not overlap one another
    parts = sorted((e for e in spans if e.name.startswith(("poseprobe.step.", "poseprobe.scene.sample"))),
                   key=lambda e: e.time_range.start)
    assert all(a.time_range.end <= b.time_range.start for a, b in zip(parts, parts[1:]))


def test_mid_step_nests_the_depth_consistency_render(monkeypatch):
    """The small scene trainer's mid step (fine sampling, depth consistency):
    every network pass emits its encode, trunk and head spans, and the trunks
    of the depth-consistency renders lie inside `poseprobe.step.depth_cons`."""
    tr = build_scene_trainer(small=True, device="cpu")
    tr.global_step = tr.fine_start + 1
    passes = _count_calls(monkeypatch, scene_nerf, "nerf_forward")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.step()
    spans = _spans(prof)
    got = collections.Counter(e.name for e in spans)
    assert len(passes) > 2 and got["poseprobe.step.depth_cons"] == 1
    for part in ("encode", "trunk", "head", "composite"):
        assert got[f"poseprobe.scene.{part}"] == len(passes), part
    dc = [e for e in spans if e.name == "poseprobe.step.depth_cons"][0]
    trunks = [e for e in spans if e.name == "poseprobe.scene.trunk"]
    inside = [t for t in trunks if _inside(t, dc)]
    assert 0 < len(inside) < len(trunks)


def test_render_full_emits_a_chunk_span_per_chunk():
    tr = build_scene_trainer(small=True, device="cpu")
    H, W, chunk = 6, 10, 16
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = evaluator.render_full(tr.scene_params, tr.cfg.scene_model, tr.poses_gt[0], tr.Ks[0], H, W,
                                    (tr.data.near, tr.data.far), chunk=chunk)
    got = collections.Counter(e.name for e in _spans(prof))
    n_chunks = -(-H * W // chunk)
    assert out["rgb"].shape == (H, W, 3)
    assert got["poseprobe.render.chunk"] == n_chunks
    assert got["poseprobe.render.rays"] == got["poseprobe.render.gather"] == 1
    passes = 1 + bool(tr.cfg.scene_model.fine_sampling)
    assert got["poseprobe.scene.trunk"] == n_chunks * passes
    chunks = [e for e in _spans(prof) if e.name == "poseprobe.render.chunk"]
    trunks = [e for e in _spans(prof) if e.name == "poseprobe.scene.trunk"]
    assert all(any(_inside(t, c) for c in chunks) for t in trunks)


def test_maskcache_fill_counts_the_compacted_lanes_in_the_mask():
    """`maskcache_fill` is the in-mask share of the N x K lanes the object
    render computes: the same draws' samples, looked up in the mask cache and
    compacted by `compact_ray_samples`, counted by hand."""
    tr = build_trainer(small=True, device="cpu")
    tr.global_step = 1
    flags = tr.phase_flags(1)
    draws = tr.sample_draws(flags)
    with torch.no_grad():
        _, metrics = tr.object_loss(tr.obj_params, tr.pose_params, 1, flags, draws)
        pose = pose_refine.current_pose_pnp(tr.pose_params, tr.poses_pnp, fix_first=tr.fix_first_pose)
        batch = batching.sample_object_batch(draws["object"], tr.images, tr.masks, tr.Ks, pose,
                                             tr.sampler_pixels, tr.sampler_counts, tr.data.inverse_y)
        om = tr.cfg.object_model
        lo, hi = object_sdf._bounds(om, torch.device("cpu"))
        samp = ray_sampling.sample_ray(batch.rays_o, batch.rays_d, lo, hi, near=tr.data.near, far=tr.data.far,
                                       stepsize=om.stepsize, voxel_size=om.voxel_size, n_samples=om.n_samples,
                                       jitter=draws["object_jitter"])
        keep = samp.mask_inbbox & maskcache.mask_lookup(tr.mask_arr, samp.pts, lo, hi)
        K = tr._mask_k or om.maskcache_K
        comp = maskcache.compact_ray_samples(samp.pts, samp.step, keep, K)
    by_hand = int(keep.sum(dim=1).clamp(max=K).sum())
    assert comp.mask.shape == (batch.rays_o.shape[0], K) and int(comp.mask.sum()) == by_hand
    assert 0 < by_hand < comp.mask.numel()
    assert metrics["maskcache_fill"].item() == pytest.approx(by_hand / comp.mask.numel(), rel=1e-6)
