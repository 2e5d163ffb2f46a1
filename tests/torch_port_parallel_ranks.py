"""The rank side of the parallel port's CPU tests: gloo ranks, no JAX.

    python tests/torch_port_parallel_ranks.py JOB_DIR RANK WORLD

A test module calls `launch` once: it writes the cases (names of the
functions below and their numpy inputs) to ``JOB_DIR/cases.pkl`` and starts
WORLD processes of this file, which join one gloo group through a file
rendezvous in JOB_DIR, run every case in order (each builds the meshes it
needs; every rank builds them in the same order) and write their results to
``JOB_DIR/out_<rank>.pkl``. The test module computes the JAX references in
its own process and compares. `launch` gives the job a deadline and ends
every rank if one fails or the deadline passes, so a hung collective fails
the test instead of stalling the run.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def launch(job_dir, world: int, cases: list, timeout_s: float, device: str = "cpu") -> list:
    """Run `cases` ([(function name, kwargs)]) on `world` ranks, their
    tensors on `device` ("cuda": every rank on the card, gloo still); returns
    each rank's {case index: result}."""
    job_dir = Path(job_dir)
    job_dir.mkdir(parents=True, exist_ok=True)
    (job_dir / "cases.pkl").write_bytes(pickle.dumps({"device": device, "cases": cases}))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]),
               OMP_NUM_THREADS="1")
    logs = [open(job_dir / f"log_{r}.txt", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, __file__, str(job_dir), str(r), str(world)], env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs) if p.returncode not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        tail = (job_dir / f"log_{bad[0]}.txt").read_text()[-4000:]
        raise RuntimeError(f"ranks {bad} of {world} failed or passed the {timeout_s:.0f} s deadline "
                           f"(return codes {[p.returncode for p in procs]}); rank {bad[0]}'s log:\n{tail}")
    return [pickle.loads((job_dir / f"out_{r}.pkl").read_bytes()) for r in range(world)]


# --------------------------------------------------------------- helpers

DEVICE = "cpu"          # the job's device, set by `main`


def _t(tree):
    """numpy tree -> torch tree on the job's device (ints and None pass through)."""
    import torch
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_t(v) for v in tree)
    return torch.from_numpy(np.array(tree)).to(DEVICE) if isinstance(tree, np.ndarray) else tree


def _n(tree):
    """torch tree -> numpy tree."""
    import torch
    if isinstance(tree, dict):
        return {k: _n(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_n(v) for v in tree)
    return tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) else tree


def tiny_joint_trainer(kw: dict, mesh=None):
    """The port's `JointTrainer` of `tests/test_torch_port_joint_step.py`'s
    tiny configuration, from its keyword dicts (`cam`, `oc`, `ot`, `sm`,
    `st`, `scene`), on the CPU."""
    from poseprobe_tpu_torch.config import config as tcfg
    from poseprobe_tpu_torch.data.synthetic import make_synthetic_scene
    from poseprobe_tpu_torch.models.object_sdf import ObjectConfig
    from poseprobe_tpu_torch.models.scene_nerf import SceneConfig
    from poseprobe_tpu_torch.train.trainer import JointTrainer
    data = make_synthetic_scene(**kw["scene"])
    cfg = tcfg.ExperimentConfig(
        data=tcfg.DataConfig(near=data.near, far=data.far), camera=tcfg.CameraConfig(**kw["cam"]),
        pnp=tcfg.PnPConfig(use_pnp=False), object_model=ObjectConfig(**kw["oc"]),
        object_train=tcfg.ObjectTrainConfig(**kw["ot"]), scene_model=SceneConfig(**kw["sm"]),
        scene_train=tcfg.SceneTrainConfig(**kw["st"]))
    return JointTrainer(cfg, data, device="cpu", mesh=mesh)


HOST_INTS = ("global_step", "n_active", "_mask_k", "_k_phase")


def trainer_state(tr) -> dict:
    """What `load_state` needs to make another trainer of the same
    configuration equal to `tr`: its state tensors and host ints."""
    return {"tensors": [t.numpy().copy() for t in tr.state_tensors()],
            **{n: getattr(tr, n) for n in HOST_INTS}}


def load_state(tr, state: dict) -> None:
    import torch
    for n in HOST_INTS:
        setattr(tr, n, state[n])
    with torch.no_grad():
        for t, a in zip(tr.state_tensors(), state["tensors"]):
            t.copy_(torch.from_numpy(a))


# ------------------------------------------------------------ the cases

def init() -> dict:
    """The group this rank joined, and the mesh over it: on the CPU when
    asked for, and refused on a machine without a card when not."""
    import torch
    import torch.distributed as dist
    from poseprobe_tpu_torch.parallel import mesh as mesh_mod
    mesh = mesh_mod.make_mesh(DEVICE)
    out = {"rank": dist.get_rank(), "world": dist.get_world_size(), "backend": dist.get_backend(),
           "mesh": mesh.shape, "device": str(mesh.device)}
    if not torch.cuda.is_available():
        try:
            mesh_mod.make_mesh()
            out["no_card"] = "no error"
        except RuntimeError as e:
            out["no_card"] = str(e)
    return out


def shard_and_replicate(rays: np.ndarray, ragged: np.ndarray, values: list) -> dict:
    """`shard_rays` / `unshard_rays` of a divisible and a ragged batch, and
    `replicated` of rank-dependent values (this rank's `values` offset by its
    rank; -0.0 and NaN kept bit for bit)."""
    import torch
    import torch.distributed as dist
    from poseprobe_tpu_torch.parallel import mesh as mesh_mod
    mesh = mesh_mod.make_mesh(DEVICE)
    out = {}
    for name, x in (("rays", rays), ("ragged", ragged)):
        x = torch.from_numpy(x)
        part = mesh_mod.shard_rays(x, mesh)
        out[name] = part.numpy()
        out[name + "_whole"] = mesh_mod.unshard_rays({"x": part}, x.shape[0], mesh)["x"].numpy()
    mine = [torch.from_numpy(np.array(v)) for v in values]
    if dist.get_rank():
        mine = [torch.zeros_like(v) if v.dtype == torch.bool else v + dist.get_rank() for v in mine]
    out["replicated"] = [v.numpy() for v in mesh_mod.replicated(mine, mesh)]
    return out


def dp_step(kw: dict, state: dict, draws) -> dict:
    """One step of the tiny joint trainer on a ('data',) mesh from `state`
    on `draws`: its metrics and the state after."""
    from poseprobe_tpu_torch.parallel import mesh as mesh_mod
    tr = tiny_joint_trainer(kw, mesh_mod.make_mesh(DEVICE))
    load_state(tr, state)
    metrics = tr.step(_t(draws))
    return {"metrics": {k: v.item() for k, v in metrics.items()}, "state": trainer_state(tr)}


def replicate_after_drift(kw: dict) -> dict:
    """Every rank but 0 moves its seeded poses, mask cache and host ints (as
    a host event through OpenCV could); `replicate_state` brings rank 0's
    back bit for bit."""
    import torch
    import torch.distributed as dist
    from poseprobe_tpu_torch.parallel import mesh as mesh_mod
    tr = tiny_joint_trainer(kw, mesh_mod.make_mesh(DEVICE))
    if dist.get_rank():
        with torch.no_grad():
            tr.poses_pnp.add_(1e-3 * dist.get_rank())
        tr.mask_arr.zero_()
        tr.n_active, tr._mask_k = tr.n_active + 1, tr._mask_k + 3
    tr.replicate_state()
    return trainer_state(tr)


def fit_across_event(kw: dict, start: int, steps: int, superstep: int) -> dict:
    """`fit(steps, superstep)` of the tiny joint trainer on a ('data',) mesh
    from step `start`, logging every window: the history and the state."""
    from poseprobe_tpu_torch.parallel import mesh as mesh_mod
    tr = tiny_joint_trainer(kw, mesh_mod.make_mesh(DEVICE))
    tr.global_step = start
    hist = tr.fit(steps, log_every=superstep, superstep=superstep)
    return {"hist": hist, "state": trainer_state(tr)}


def render_full(kw: dict, state: dict, view: int, chunk: int) -> dict:
    """`render_full_image` of a train view on a ('data',) mesh from `state`,
    and the same render without a mesh."""
    from poseprobe_tpu_torch.parallel import mesh as mesh_mod
    tr = tiny_joint_trainer(kw, mesh_mod.make_mesh(DEVICE))
    load_state(tr, state)
    pose, K = tr.poses_gt[view], tr.Ks[view]
    meshed = tr.render_full_image(pose, K, chunk=chunk)
    tr.mesh = None
    return {"mesh": _n(meshed), "alone": _n(tr.render_full_image(pose, K, chunk=chunk))}


def _grid_mesh(shape: tuple):
    from poseprobe_tpu_torch.parallel import grid_tp
    return grid_tp.make_grid_mesh(*shape, device=DEVICE)


def sample(shape: tuple, grid: np.ndarray, pts: np.ndarray, lo, hi, data_sharded: bool) -> dict:
    """`sample_grid_tp` on this rank's slab and its points (its data share
    when `data_sharded`): the values, the gradients of sum(sin(values)) for
    the slab and the points, and the trilinear kernels' launches."""
    import torch
    from poseprobe_tpu_torch.ops import grid as grid_ops
    from poseprobe_tpu_torch.parallel import grid_tp
    mesh = _grid_mesh(shape)
    daxis = mesh.axis("data")
    slab = grid_tp.shard_grid(_t(grid), mesh).requires_grad_(True)
    p = _t(pts)
    if data_sharded:
        n = p.shape[0] // daxis.size
        p = p[daxis.index * n:(daxis.index + 1) * n]
    p = p.clone().requires_grad_(True)
    out = grid_tp.sample_grid_tp(slab, p, lo, hi, mesh, data_sharded_points=data_sharded)
    g_slab, g_pts = torch.autograd.grad(torch.sin(out).sum(), [slab, p])
    return {"out": _n(out), "g_grid": _n(g_slab), "g_pts": _n(g_pts),
            "launches": (grid_ops.fwd_launches, grid_ops.bwd_launches)}


def tv(shape: tuple, grid: np.ndarray, mask) -> dict:
    """`total_variation_tp` of this rank's slab (and mask) and its gradient."""
    import torch
    from poseprobe_tpu_torch.parallel import grid_tp
    mesh = _grid_mesh(shape)
    slab = grid_tp.shard_grid(_t(grid), mesh).requires_grad_(True)
    m = None if mask is None else grid_tp.shard_grid(_t(mask), mesh)
    val = grid_tp.total_variation_tp(slab, mesh, m)
    (g,) = torch.autograd.grad(val, [slab])
    return {"value": val.item(), "g_grid": _n(g)}


def indivisible(shape: tuple, grid: np.ndarray) -> str:
    import torch
    from poseprobe_tpu_torch.parallel import grid_tp
    mesh = _grid_mesh(shape)
    try:
        grid_tp.shard_grid(torch.from_numpy(grid), mesh)
    except ValueError as e:
        return str(e)
    return "no error"


def train_step(shape: tuple, sdf, k0, rays_o, rays_d, tgt, msk, **kw) -> dict:
    """`train_step_tp` on this rank's slabs: the new slabs and the metrics."""
    from poseprobe_tpu_torch.parallel import grid_tp, object_tp
    mesh = _grid_mesh(shape)
    slabs = [grid_tp.shard_grid(_t(g), mesh) for g in (sdf, k0)]
    new_sdf, new_k0, m = object_tp.train_step_tp(*slabs, *_t([rays_o, rays_d, tgt, msk]), mesh=mesh, **kw)
    return {"sdf": _n(new_sdf), "k0": _n(new_k0), "metrics": {k: v.item() for k, v in m.items()}}


def joint_step(shape: tuple, params: dict, scene_kw: dict, rays_cam, base, tgt, msk, **kw) -> dict:
    """`joint_step_tp` on this rank's slabs: the new params and the metrics."""
    from poseprobe_tpu_torch.models.scene_nerf import SceneConfig
    from poseprobe_tpu_torch.parallel import grid_tp, object_tp
    mesh = _grid_mesh(shape)
    p = _t(params)
    p["sdf"], p["k0"] = (grid_tp.shard_grid(p[k], mesh) for k in ("sdf", "k0"))
    new, m = object_tp.joint_step_tp(p, SceneConfig(**scene_kw), *_t([rays_cam, base, tgt, msk]), mesh=mesh, **kw)
    return {"params": _n(new), "metrics": {k: v.item() for k, v in m.items()}}


def main(job_dir: str, rank: int, world: int) -> None:
    global DEVICE
    import torch
    from poseprobe_tpu_torch.parallel import multihost
    torch.set_num_threads(1)
    job = pickle.loads((Path(job_dir) / "cases.pkl").read_bytes())
    DEVICE, cases = job["device"], job["cases"]
    if not multihost.init_distributed(f"file://{job_dir}/rendezvous", world, rank, backend="gloo", timeout_s=120):
        raise RuntimeError("no process group")
    out = {i: globals()[name](**kwargs) for i, (name, kwargs) in enumerate(cases)}
    (Path(job_dir) / f"out_{rank}.pkl").write_bytes(pickle.dumps(out))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
