"""Self-describing checkpoints of a `JointTrainer`, in the JAX package's format v2.

Port of `poseprobe_tpu/train/state.py`. A checkpoint is one ``.npz`` archive:
every parameter and optimizer-state leaf is a named array entry, and a
``__manifest__`` member (JSON as uint8) records the format version, each
section's leaves (keypath, array key, dtype, shape), the scalars `step`,
`n_active` and `best_val`, the configs and the names of the host-side extras.
The sections, keypath strings, leaf order, dtypes and shapes are those of the
JAX trainer's `TrainState` at the same config: the port's parameter trees
already have the JAX layout, and `convert.py` maps its {count, mu, nu}
optimizer states to the optax chains' keypaths (counts as int32). So a file
written by either package loads in the other: the JAX package's own
`load_checkpoint` / `restore_state` reads a port file, and `restore_state`
here reads a JAX file.

Writes are atomic (a temporary file, then a rename), with a human-readable
``.json`` sidecar of the configs. Only v2 files load: a v1 file is a pickle,
which may hold JAX arrays, and `load_checkpoint` refuses it with a
`ValueError` that names the format.
"""
from __future__ import annotations

import json
import os
import zipfile

import numpy as np
import torch

from .. import convert
from ..core.tree import tree_unflatten

CKPT_VERSION = 2
SECTIONS = ("obj_params", "scene_params", "pose_params", "opt_obj", "opt_scene", "opt_pose")


def _section_entries(trainer) -> dict:
    """{section: [(keypath, leaf)]} of the trainer's state, as the JAX
    `TrainState` flattens. The scene chain has `clip_by_global_norm` first
    when clipping is on, which moves its Adam to element 1."""
    clip = bool(trainer.cfg.scene_train.nerf_gradient_clipping)
    return {
        "obj_params": convert.keyed_leaves(trainer.obj_params),
        "scene_params": convert.keyed_leaves(trainer.scene_params),
        "pose_params": convert.keyed_leaves(trainer.pose_params),
        "opt_obj": convert.object_adam_entries(trainer.opt_obj_state),
        "opt_scene": convert.adam_entries(trainer.opt_scene_state, 1 if clip else 0),
        "opt_pose": convert.adam_entries(trainer.opt_pose_state, 0),
    }


def save_checkpoint(path: str, trainer, configs: dict | None = None, extras: dict | None = None) -> None:
    """Write `trainer`'s state to `path` (atomic: a temporary file, then a
    rename), and `configs` to ``path + ".json"``. `extras`: host-side arrays
    by name (`trainer.host_extras()`), read back by `get_extras`."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays: dict = {}
    manifest: dict = {
        "format": "poseprobe_ckpt", "version": CKPT_VERSION, "sections": {}, "extras": [],
        "scalars": {"step": int(trainer.global_step), "n_active": int(trainer.n_active),
                    "best_val": float(trainer.best_val)},
        "configs": json.loads(json.dumps(configs or {}, default=str)),
    }
    for sec, entries in _section_entries(trainer).items():
        listed = []
        for i, (p, leaf) in enumerate(entries):
            arr = convert.leaf_to_numpy(leaf)
            key = f"{sec}.{i:05d}"
            arrays[key] = arr
            listed.append({"path": p, "key": key, "dtype": str(arr.dtype), "shape": list(arr.shape)})
        manifest["sections"][sec] = listed
    arrays["poses_pnp"] = convert.leaf_to_numpy(trainer.poses_pnp).astype(np.float32)
    for name, val in (extras or {}).items():
        if val is None:
            continue
        arrays[f"extra.{name}"] = np.asarray(val)
        manifest["extras"].append(name)
    arrays["__manifest__"] = np.frombuffer(json.dumps(manifest).encode("utf-8"), dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    if configs is not None:
        with open(path + ".json", "w") as f:
            json.dump(configs, f, indent=2, default=str)


def load_checkpoint(path: str) -> dict:
    """Open a v2 checkpoint. Returns the payload for `restore_state` /
    `get_extras`: {'version', 'npz', 'manifest'}."""
    if not zipfile.is_zipfile(path):
        raise ValueError(f"{path} is not a format-v2 checkpoint (an .npz archive): format v1 (a pickle, "
                         "which may hold JAX arrays) is not read by the port")
    z = np.load(path, allow_pickle=False)
    manifest = json.loads(bytes(z["__manifest__"].tobytes()).decode("utf-8"))
    if manifest.get("version", 0) != CKPT_VERSION:
        raise ValueError(f"checkpoint {path} has version {manifest.get('version')}; the port reads "
                         f"version {CKPT_VERSION}")
    return {"version": manifest["version"], "npz": z, "manifest": manifest}


def grid_type(payload: dict) -> str:
    """The feature grid's backend in a checkpoint: "tensorf" where k0 is a
    tree of planes and vectors, else "dense"."""
    paths = [e["path"] for e in payload["manifest"]["sections"]["obj_params"]]
    return "tensorf" if any(p.startswith("['k0_grid'][") for p in paths) else "dense"


def get_extras(payload: dict) -> dict:
    """The host-side extras saved with the state, by name."""
    z = payload["npz"]
    return {name: z[f"extra.{name}"] for name in payload["manifest"]["extras"]}


def restore_state(trainer, payload: dict) -> None:
    """Load a checkpoint's state into `trainer` (built from the same config):
    params, optimizer states, seeded poses and scalars, then its host extras
    (`trainer.restore_host_extras`, which sets the object config from the
    saved voxel count). The keypaths of every section must be the trainer's;
    the shapes come from the file (progressive grid scaling makes the saved
    grids larger than a fresh trainer's). The state tensors are rebound, so
    a captured step is dropped and the next window captures again."""
    z, man = payload["npz"], payload["manifest"]
    arrays = {}
    for sec, entries in _section_entries(trainer).items():
        saved = man["sections"][sec]
        want = [p for p, _ in entries]
        if [e["path"] for e in saved] != want:
            raise ValueError(f"checkpoint section {sec} holds {[e['path'] for e in saved]}, the trainer "
                             f"{want}: a config mismatch")
        arrays[sec] = {e["path"]: z[e["key"]] for e in saved}
    device = trainer.device

    def params(sec, like):
        return tree_unflatten(like, [
            torch.as_tensor(np.array(arrays[sec][p], dtype=np.float32), device=device)
            for p, _ in convert.keyed_leaves(like)])

    clip = bool(trainer.cfg.scene_train.nerf_gradient_clipping)
    trainer.drop_graphs()
    trainer.obj_params = params("obj_params", trainer.obj_params)
    trainer.scene_params = params("scene_params", trainer.scene_params)
    trainer.pose_params = params("pose_params", trainer.pose_params)
    trainer.opt_obj_state = convert.object_adam_state_from_entries(arrays["opt_obj"], trainer.opt_obj_state, device)
    trainer.opt_scene_state = convert.adam_state_from_entries(arrays["opt_scene"], trainer.opt_scene_state,
                                                              1 if clip else 0, device)
    trainer.opt_pose_state = convert.adam_state_from_entries(arrays["opt_pose"], trainer.opt_pose_state, 0, device)
    trainer.poses_pnp = torch.as_tensor(np.array(z["poses_pnp"], dtype=np.float32), device=device)
    scal = man["scalars"]
    trainer.global_step = int(scal["step"])
    trainer.n_active = int(scal["n_active"])
    trainer.best_val = float(scal["best_val"])
    trainer.restore_host_extras(get_extras(payload))
