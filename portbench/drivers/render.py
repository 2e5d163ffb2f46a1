"""Window driver of the rendering cells: `eval.evaluator.render_full` over
bands of one full-resolution test view.

Set-up makes the view's camera (`data/synthetic.camera_rig`) and the scene
weights from the seed (`weights.py`), and renders one band to warm its
shapes. A unit of the measured window renders the next band of the view, a
horizontal strip of `band_rows` rows, through `render_full`'s own defaults
(chunks of 4096 rays, the fine network, progress 1.0) with the camera's
principal point moved to the band, then synchronises; the bands cycle over
the view. After the window, bands drawn from the seed among those rendered
are rendered again by the reference (`reference/render.py`) and compared
(`reference/compare.py`).
"""
from __future__ import annotations

import dataclasses
import random
import time

import torch

from portbench import guard, weights as weights_mod
from portbench.counts import work as work_mod
from portbench.data import synthetic
from portbench.reference import compare, render as ref_render, step as ref_step
from portbench.reference.port.models import scene_nerf as ref_scene


class Window:
    def __init__(self, run):
        from poseprobe_tpu_torch.eval import evaluator
        from poseprobe_tpu_torch.ops import _build

        self.run, cell, conf = run, run.cell, run.config
        device = run.device
        if device.type == "cuda":
            _build.build()
        self.render_full = evaluator.render_full
        t0 = time.perf_counter()
        cfg = guard.check(conf)
        s = conf["scene"]
        if s["kind"] != "synthetic_rig":
            raise ValueError(f"the render driver has no scene of kind {s['kind']!r}")
        poses, Ks = synthetic.camera_rig(s["n_train"], s["n_test"], s["H"], s["W"], s["seed"])
        self.H, self.W = s["H"], s["W"]
        self.pose = torch.as_tensor(poses[s["test_view"]], device=device)
        self.K = Ks[s["test_view"]].copy()
        self.sm = cfg.scene_model
        self.depth_range = (cfg.data.near, cfg.data.far)
        run.spans["data_setup_s"] = time.perf_counter() - t0

        ref_sm = ref_step.build_config(conf["experiment"]).scene_model
        template = ref_scene.init_scene_params(torch.Generator().manual_seed(0), ref_sm, "cpu")
        self.params = weights_mod.make(template, run.seed, device)
        self.rows = cell["band_rows"]
        self.starts = list(range(0, self.H - self.rows + 1, self.rows))
        if self.starts[-1] + self.rows < self.H:
            self.starts.append(self.H - self.rows)
        self.work_per_unit = self.rows * self.W
        rng = random.Random(run.seed)
        self.sampled = [0] + sorted(rng.sample(range(1, cell["checked_within"]), cell["checked_bands"] - 1))
        self.kept, self.n, self.bad = {}, 0, 0
        band = work_mod.render_band(conf["experiment"], self.rows * self.W, 4096)
        run.work = {"flops": band["flops"], "bands": 1}
        self.trace_units, self.trace_work = cell["trace_units"], {"bands": cell["trace_units"], "band": band}
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        self._band(0)                      # warm the band's shapes
        self.n, self.kept = 0, {}

    def _band(self, start: int) -> dict:
        K = self.K.copy()
        K[1, 2] -= start
        out = self.render_full(self.params, self.sm, self.pose, torch.as_tensor(K, device=self.run.device),
                               self.rows, self.W, self.depth_range)
        if self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)
        return out

    def unit(self) -> None:
        start = self.starts[self.n % len(self.starts)]
        out = self._band(start)
        if self.n in self.sampled:
            self.kept[self.n] = (start, {k: out[k].detach().cpu() for k in ("rgb", "depth", "opacity")})
        self.bad += int(not all(bool(torch.isfinite(out[k]).all()) for k in ("rgb", "depth", "opacity")))
        self.n += 1

    def trace_unit(self) -> None:
        self._band(self.starts[1 % len(self.starts)])

    def tally(self) -> tuple[int, int]:
        return self.n, self.bad

    def close(self) -> None:
        self.render_full = None

    def reference_band(self, start: int, precision: str | None = None) -> dict:
        ecfg = ref_step.build_config(self.run.config["experiment"])
        sm = ecfg.scene_model if precision is None else dataclasses.replace(ecfg.scene_model,
                                                                           matmul_dtype=precision)
        K = self.K.copy()
        K[1, 2] -= start
        out = ref_render.render_full(self.params, sm, self.pose, torch.as_tensor(K, device=self.run.device),
                                     self.rows, self.W, self.depth_range)
        return {k: out[k].cpu() for k in ("rgb", "depth", "opacity")}

    def readings(self, side: str = "program") -> dict:
        """The gaps of `side` ("program" or "control") against the reference,
        the worst over the checked bands."""
        if not self.kept:
            raise RuntimeError("no checked band was rendered in the window")
        worst: dict = {}
        for start, prog in self.kept.values():
            ref = self.reference_band(start)
            got = prog if side == "program" else self.reference_band(start, precision="float8_e4m3fn")
            gaps = compare.render_gaps(got, ref, self.depth_range)
            worst = {k: max(v, worst.get(k, 0.0)) for k, v in gaps.items()}
        return worst

    def check(self) -> list:
        limits = self.run.cell["limits"]
        gaps = self.readings("program")
        return [{"name": k, "value": gaps[k], "limit": limits[k]} for k in limits]


def setup(run) -> Window:
    return Window(run)
