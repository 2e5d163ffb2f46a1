"""Carry parameters and optimizer state between the JAX package and the port.

Both packages store parameters as nested dicts/lists in the same layout
(`w` is [in, out]); on the JAX side the leaves are given as numpy arrays
(`jax.tree.map(np.asarray, tree)`), so this module needs no JAX. Adam state
is recognised by its fields: the optax chain's `ScaleByAdamState` has
`count`, `mu` and `nu`; its `ScaleByScheduleState` has only `count`. The
object optimizer's `multi_transform` state holds one such chain per label
under `inner_states[label].inner_state`, its moments shaped like the whole
param tree with the other labels' leaves masked out.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.tree import tree_map
from .train.optim import _OBJECT_MODULES


def tree_from_numpy(tree, device="cuda"):
    """Nested dicts/lists of numpy arrays -> the same of float32 tensors."""
    return tree_map(lambda a: torch.as_tensor(np.array(a, dtype=np.float32), device=device), tree)


def tree_to_numpy(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def scene_params_from_jax(tree, device="cuda") -> dict:
    """JAX scene param tree {'nerf': {'feat': [...], 'rgb': [...]}, 'nerf_fine': ...}."""
    return tree_from_numpy(tree, device)


def object_params_from_jax(tree, device="cuda") -> dict:
    """JAX object param tree {'sdf_grid', 'k0_grid', 'rgbnet', 'warpnet',
    'sdf_alpha', 'sdf_beta', 's_val'}."""
    return tree_from_numpy(tree, device)


def pose_params_from_jax(tree, device="cuda") -> dict:
    """JAX pose param tree {'se3_refine': [n, 6], 'se3_align_refine': [1, 6]}."""
    return tree_from_numpy(tree, device)


def adam_state_from_jax(opt_state, device="cuda") -> dict | None:
    """An optax chain state (a tuple holding a ScaleByAdamState) -> the port's
    optimizer state {'count', 'mu', 'nu'}; None for a chain without Adam
    (set_to_zero). The schedule's count equals Adam's in these chains, which
    is checked."""
    states = opt_state if _fields(opt_state) == () else (opt_state,)
    adam = [s for s in states if {"count", "mu", "nu"} <= set(_fields(s))]
    if not adam:
        return None
    count = int(np.asarray(adam[0].count))
    for s in states:
        if _fields(s) == ("count",) and int(np.asarray(s.count)) != count:
            raise ValueError("schedule count differs from Adam's count")
    return {"count": _count(count, device), "mu": tree_from_numpy(adam[0].mu, device),
            "nu": tree_from_numpy(adam[0].nu, device)}


def object_adam_state_from_jax(opt_state, device="cuda") -> dict:
    """The optax `multi_transform` state of the object optimizer -> the port's
    `ObjectOptimizer` state {'count', 'mu': {param key: ...}, 'nu': ...} over
    the trainable (lr > 0) modules. Every label's Adam and schedule counts
    must agree: the port keeps one count."""
    counts, mu, nu = set(), {}, {}
    for key, label in _OBJECT_MODULES.items():
        chain = opt_state.inner_states[label].inner_state
        if _fields(chain) != ():
            continue                      # set_to_zero (an EmptyState): a frozen module
        for s in chain:
            if "count" in _fields(s):
                counts.add(int(np.asarray(s.count)))
            if {"mu", "nu"} <= set(_fields(s)):
                # the other labels' leaves are masked out of this label's moments
                mu[key], nu[key] = tree_from_numpy(s.mu[key], device), tree_from_numpy(s.nu[key], device)
    if len(counts) != 1:
        raise ValueError(f"object optimizer counts differ between modules: {sorted(counts)}")
    return {"count": _count(counts.pop(), device), "mu": mu, "nu": nu}


def _count(count: int, device) -> torch.Tensor:
    """The port keeps an optimizer's count as an int64 tensor on the device,
    advanced in place by the step."""
    return torch.tensor(count, dtype=torch.int64, device=device)


def _fields(state) -> tuple:
    """Field names of an optax state (a NamedTuple); () for a plain tuple."""
    return tuple(getattr(state, "_fields", ()))


def adam_state_to_numpy(state: dict | None) -> dict | None:
    """The port's optimizer state -> {'count': int, 'mu', 'nu'} of numpy arrays,
    from which a caller rebuilds the optax states."""
    if state is None:
        return None
    return {"count": int(state["count"]), "mu": tree_to_numpy(state["mu"]),
            "nu": tree_to_numpy(state["nu"])}


def load_trainer_state(trainer, state, mask_arr=None, mask_k=None, k_phase=None) -> None:
    """Load a JAX `TrainState` (leaves as numpy arrays) into the port's trainer:
    params, Adam states, the seeded poses, the step and the number of active
    views; for a joint trainer also the object branch and, where given, the
    mask cache (`mask_arr` [X, Y, Z] bool), its lane budget `mask_k` and the
    plastic-phase chord bound `k_phase`, so that a state taken after a host
    pose event carries over whole."""
    device = trainer.device
    trainer.scene_params = scene_params_from_jax(state.scene_params, device)
    trainer.pose_params = pose_params_from_jax(state.pose_params, device)
    trainer.opt_scene_state = adam_state_from_jax(state.opt_scene, device)
    trainer.opt_pose_state = adam_state_from_jax(state.opt_pose, device)
    trainer.poses_pnp = torch.as_tensor(np.array(state.poses_pnp, dtype=np.float32), device=device)
    trainer.global_step = int(state.step)
    trainer.n_active = int(state.n_active)
    if "obj" in trainer.GROUPS:
        trainer.obj_params = object_params_from_jax(state.obj_params, device)
        trainer.opt_obj_state = object_adam_state_from_jax(state.opt_obj, device)
        if mask_arr is not None:
            trainer.mask_arr = torch.as_tensor(np.array(mask_arr, dtype=bool), device=device)
        trainer._mask_k = None if mask_k is None else int(mask_k)
        if k_phase is not None:
            trainer._k_phase = int(k_phase)
