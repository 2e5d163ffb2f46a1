"""Window driver of the training cells: `JointTrainer.steps_scan(K)` windows.

Set-up builds one trainer from the cell's configuration and the benchmark's
scene (`data/synthetic.py`), loads into it the weights the benchmark made from
the seed (`weights.py`), places it at the cell's state (every train view
active where the cell says so; the step number by the `global_step` setter)
and seeds the generator its step draws from. It then drives that trainer
through its first three steps by the window's own call, `steps_scan`
(`steps_scan(1)`: the eager first step and the capture; `steps_scan(2)`: two
replays), reading the losses, the first gradient (from Adam's first moment)
and the parameters' change, and warms one whole window. A unit of the
measured window restarts at the cell's start step and runs `steps_scan(K)`,
then synchronises. After the window the same three steps run in the
reference (`reference/step.py`) from the same inputs and are compared
(`reference/compare.py`).
"""
from __future__ import annotations

import dataclasses
import time

import torch

from portbench import guard, weights as weights_mod
from portbench.counts import work as work_mod
from portbench.data import synthetic
from portbench.reference import compare, step as ref_step

CHECKED_STEPS = 3


def draw_seed(seed: int) -> int:
    """The seed of the step's draws, apart from the weights' stream."""
    return (seed * 0x9E3779B1 + 0x632BE5AB) % (1 << 62)


def make_scene(conf: dict):
    """The benchmark's scene of the configuration (numpy arrays)."""
    s = dict(conf["scene"])
    if s.pop("kind") != "synthetic":
        raise ValueError(f"the train driver has no scene of kind {conf['scene']['kind']!r}")
    return synthetic.make_synthetic_scene(**s)


def scene_arrays(scene) -> dict:
    """What the reference is handed of the scene."""
    return {"images": scene.images, "masks": scene.masks, "Ks": scene.Ks, "poses_gt_w2c": scene.poses_gt_w2c,
            "i_train": scene.i_train, "scene_matches": scene.scene_matches, "obj_matches": scene.obj_matches,
            "pair_j": scene.pair_j, "sampler_pixels": scene.samplers.pixels, "sampler_counts": scene.samplers.counts,
            "near": scene.near, "far": scene.far, "inverse_y": scene.inverse_y, "white_bkgd": scene.white_bkgd}


def port_scene(scene):
    """The scene as the port's `SceneData`."""
    from poseprobe_tpu_torch.data import base
    fields = {f: getattr(scene, f) for f in base.SceneData.__dataclass_fields__}
    fields["samplers"] = base.SemanticSamplers(pixels=scene.samplers.pixels, counts=scene.samplers.counts)
    return base.SceneData(**fields)


def _groups(tr) -> dict:
    return {"obj": tr.obj_params, "scene": tr.scene_params, "pose": tr.pose_params}


def norms(tree: dict, prefix: str, scale: float = 1.0) -> dict:
    return {f"{prefix}.{p}": float(torch.linalg.vector_norm(t.float())) * scale
            for p, t in weights_mod.named_leaves(tree)}


def moments(owner, names: list) -> dict:
    """Leaf norms of the first gradient, from each trained group's Adam first
    moment after one step (mu = (1 - b1) g)."""
    out = {}
    for n in names:
        opt, state = getattr(owner, f"opt_{n}"), getattr(owner, f"opt_{n}_state")
        out.update(norms(state["mu"], n, 1.0 / (1.0 - opt.b1)))
    return out


def trained(flags: dict, cfg) -> list:
    return ((["obj"] if flags["object_on"] else []) + ["scene"]
            + (["pose"] if flags["pose_on"] and cfg.object_train.lr_pose > 0 else []))


class Window:
    def __init__(self, run):
        from poseprobe_tpu_torch.ops import _build
        from poseprobe_tpu_torch.train import trainer as trainer_mod

        self.run, cell, conf = run, run.cell, run.config
        device = run.device
        if device.type == "cuda":
            _build.build()
        t0 = time.perf_counter()
        cfg = guard.check(conf)
        self.scene = make_scene(conf)
        self.tr = tr = trainer_mod.JointTrainer(cfg, port_scene(self.scene), device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        run.spans["data_setup_s"] = time.perf_counter() - t0

        om = tr.cfg.object_model
        self.weights = weights_mod.make(_groups(tr), run.seed, device, box=(om.xyz_min, om.xyz_max))
        weights_mod.load_into(_groups(tr), self.weights)
        if cell["views"] == "all":
            tr.n_active = tr.n_train
        self.start, self.K = cell["start_step"], cell["superstep"]
        if tr._next_boundary(self.start) < self.start + self.K:
            raise ValueError(f"a window of {self.K} steps from {self.start} crosses the boundary at "
                             f"{tr._next_boundary(self.start)}")
        flags = tr.phase_flags(self.start)
        self.flags, self.groups = flags, trained(flags, tr.cfg)
        self.seed_draws = draw_seed(run.seed)

        # the first three steps, through the window's own call, from the benchmark's state
        tr.global_step = self.start
        tr.generator.manual_seed(self.seed_draws)
        before = {n: {k: t.detach().clone() for k, t in weights_mod.named_leaves(g)}
                  for n, g in _groups(tr).items()}
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        first = tr.steps_scan(1)
        self.program = {"grad_norms": moments(tr, self.groups)}
        rest = tr.steps_scan(CHECKED_STEPS - 1)
        losses = torch.cat([first["loss_total"], rest["loss_total"]])
        self.program["losses"] = [float(x) for x in losses]
        after = {n: dict(weights_mod.named_leaves(g)) for n, g in _groups(tr).items()}
        self.program["change_norms"] = {
            f"{n}.{p}": float(torch.linalg.vector_norm(after[n][p].float() - before[n][p].float()))
            for n in self.groups for p in before[n]}
        del before, after
        if tr._graphs.graph is not None:
            run.values["graph_capture_s"] = tr._graphs.graph.capture_s

        # the work, counted from the configuration
        wcfg = dict(conf["experiment"], _matches=int(self.scene.scene_matches.shape[1]),
                    _n_samples=om.n_samples)
        step_work = work_mod.train_step(wcfg, tr.n_active, flags, tr._mask_k)
        self.work_per_unit = self.K * (conf["experiment"]["scene_model"]["rand_rays"]
                                       + (conf["experiment"]["object_train"]["N_rand"] if flags["object_on"] else 0))
        run.work = {"flops": step_work["flops"] * self.K, "steps": self.K}
        self.trace_units, self.trace_steps = cell["trace_units"], cell["trace_steps"]
        self.trace_work = {"steps": self.trace_units * self.trace_steps, "step": step_work}
        self.losses = []
        self.unit()                        # one whole warm window (replays only)
        self.losses = []

    def unit(self) -> None:
        self.tr.global_step = self.start
        self.losses.append(self.tr.steps_scan(self.K)["loss_total"])
        if self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)

    def trace_unit(self) -> None:
        self.tr.global_step = self.start
        self.tr.steps_scan(self.trace_steps)
        if self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)

    def tally(self) -> tuple[int, int]:
        losses = torch.cat(self.losses) if self.losses else torch.zeros(0)
        return int(losses.numel()), int((~torch.isfinite(losses)).sum())

    def close(self) -> None:
        self.tr.drop_graphs()
        del self.tr
        self.losses = []

    def reference_readings(self, precision: str | None = None, fault: str | None = None) -> dict:
        """The checked steps in the reference, from the same inputs: as the
        configuration states, or (a control) with the MLPs in `precision` and
        float32 matmuls in TF32, or with `fault` planted."""
        ecfg = ref_step.build_config(self.run.config["experiment"])
        if precision is not None:
            ecfg = dataclasses.replace(ecfg, scene_model=dataclasses.replace(ecfg.scene_model, matmul_dtype=precision))
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = precision is not None
        try:
            ref = ref_step.RefStep(ecfg, scene_arrays(self.scene), self.weights, self.flags["n_active"],
                                   self.seed_draws, self.run.device, fault=fault)
            before = {n: {k: t.detach().clone() for k, t in weights_mod.named_leaves(getattr(ref, f"{n}_params"))}
                      for n in self.groups}
            out = {"losses": [ref.step(self.start)["loss_total"]]}
            out["grad_norms"] = moments(ref, self.groups)
            for i in range(1, CHECKED_STEPS):
                out["losses"].append(ref.step(self.start + i)["loss_total"])
            out["change_norms"] = {
                f"{n}.{p}": float(torch.linalg.vector_norm(t.float() - before[n][p].float()))
                for n in self.groups for p, t in weights_mod.named_leaves(getattr(ref, f"{n}_params"))}
            out["mask_k"] = ref.mask_k
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        return out

    def readings(self, side: str = "program") -> dict:
        """The gaps of `side` ("program", "control" or "half_batch") against the reference."""
        ref = self.reference_readings()
        if side == "program":
            got = self.program
        elif side == "control":
            got = self.reference_readings(precision="float8_e4m3fn")
        else:
            got = self.reference_readings(fault=side)
        return compare.train_gaps(got, ref)

    def check(self) -> list:
        limits = self.run.cell["limits"]
        gaps = self.readings("program")
        return [{"name": k, "value": gaps[k], "limit": limits[k]} for k in limits]


def setup(run) -> Window:
    return Window(run)
