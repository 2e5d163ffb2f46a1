"""Object, scene and pose optimizers, written out to reproduce the reference's
optax chains.

Port of `build_object_optimizer`, `build_scene_optimizer` and
`build_pose_optimizer` of `poseprobe_tpu/train/optim.py`. Parameters, gradients and moments are nested
dicts/lists of tensors (the JAX trees). ``update(grads, state) -> (updates,
state)`` advances the state in place: the moments and the step count are
tensors on the params' device, and the lrs and bias corrections are tensor
math on that count, evaluated in float32 as optax does in the reference's
traced step. So the step that calls it holds no per-step number on the host
and can be captured by a CUDA graph. The caller adds the updates. Matching
optax exactly:

* clip-by-global-norm multiplies by ``max_norm / norm`` only when
  ``norm >= max_norm`` (not ``torch.nn.utils.clip_grad_norm_``'s
  ``max_norm / (norm + 1e-6)``);
* Adam's eps is added outside the sqrt; moments are bias-corrected with the
  incremented count;
* the lr schedule is evaluated at the count before its increment, and that
  count is the schedule's own (it equals Adam's).
"""
from __future__ import annotations

import torch

from ..config import ObjectTrainConfig, SceneTrainConfig
from ..core.tree import tree_leaves, tree_map, tree_unflatten


def _count(state: dict, like: torch.Tensor) -> torch.Tensor:
    """The state's count as an int64 tensor on `like`'s device, stored back
    into the state if it was given as a number."""
    if not isinstance(state["count"], torch.Tensor):
        state["count"] = torch.tensor(state["count"], dtype=torch.int64, device=like.device)
    return state["count"]


class _Adam:
    """Adam moments + an lr schedule over a param tree (optax
    scale_by_adam -> schedule -> scale(-1))."""

    def __init__(self, b1: float, b2: float, eps: float = 1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params) -> dict:
        zeros = lambda t: torch.zeros_like(t, dtype=torch.float32)  # noqa: E731
        device = tree_leaves(params)[0].device
        return {"count": torch.zeros((), dtype=torch.int64, device=device),
                "mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}

    def bias_corrections(self, count) -> tuple:
        """1 - b1^count and 1 - b2^count at `count` (a number or a tensor), in
        float32 as optax has them."""
        t = torch.as_tensor(count).to(torch.float32)
        return 1.0 - self.b1 ** t, 1.0 - self.b2 ** t

    def _direction(self, grads, state):
        """Adam direction mu_hat / (sqrt(nu_hat) + eps). Advances the moments
        and the count in place; the caller takes its lr from the count first."""
        g, mu, nu = tree_leaves(grads), tree_leaves(state["mu"]), tree_leaves(state["nu"])
        count = _count(state, g[0])
        c1, c2 = self.bias_corrections(count + 1)
        # mu = (1 - b1) g + b1 mu and nu = (1 - b2) g^2 + b2 nu, rounded as optax rounds them
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - self.b1))
        sq = torch._foreach_mul(g, g)
        torch._foreach_mul_(sq, 1.0 - self.b2)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, sq)
        count.add_(1)
        return [(m / c1) / (torch.sqrt(v / c2) + self.eps) for m, v in zip(mu, nu)]


# object param key -> the lr field of ObjectTrainConfig and the module name of
# `decay_step_module`; `s_val` has neither: it is frozen
_OBJECT_MODULES = {"sdf_grid": "sdf", "k0_grid": "k0", "rgbnet": "rgbnet", "warpnet": "warpnet",
                   "sdf_alpha": "sdf_alpha", "sdf_beta": "sdf_beta"}


class ObjectOptimizer(_Adam):
    """Adam (0.9, 0.99) per object module (top-level param key) with its own lr:
    ``lr * 0.1^(count / (lrate_decay * 1000))`` times the staged
    `decay_step_module` drops reached by `count`. A module with lr <= 0, and
    `s_val`, is frozen: zero updates and no state. `count` is the number of
    updates since `init` (after a grid rescale the trainer calls `init` again
    and the schedules restart, as the reference's do). Every leaf under a
    module key is updated, `warpnet["output_range"]` included."""

    def __init__(self, cfg: ObjectTrainConfig):
        super().__init__(0.9, 0.99)
        self.decay_steps = cfg.lrate_decay * 1000
        self.base_lr = {key: getattr(cfg, f"lrate_{mod}") for key, mod in _OBJECT_MODULES.items()}
        self.events = {key: [(step, dict(factors)[mod]) for step, factors in cfg.decay_step_module
                             if mod in dict(factors)] for key, mod in _OBJECT_MODULES.items()}

    def trainable(self, params: dict) -> dict:
        return {k: v for k, v in params.items() if self.base_lr.get(k, 0.0) > 0}

    def init(self, params: dict) -> dict:
        return super().init(self.trainable(params))

    def lr(self, key: str, count) -> torch.Tensor:
        """The module's lr at `count` (a number or a 0-dim tensor)."""
        count = torch.as_tensor(count)
        lr = self.base_lr[key] * 0.1 ** (count / self.decay_steps)
        for ev_step, factor in self.events[key]:
            lr = lr * torch.where(count >= ev_step, factor, 1.0)
        return lr

    def update(self, grads: dict, state: dict):
        sub = self.trainable(grads)
        if not sub:
            return tree_map(torch.zeros_like, grads), state
        count = _count(state, tree_leaves(sub)[0])
        lrs = {key: self.lr(key, count) for key in sub}
        d = tree_unflatten(sub, self._direction(sub, state))
        updates = {}
        for key, g in grads.items():
            if key in sub:
                updates[key] = tree_map(lambda x, lr=lrs[key]: -(lr * x), d[key])
            else:
                updates[key] = tree_map(torch.zeros_like, g)
        return updates, state


class SceneOptimizer(_Adam):
    """Adam (0.9, 0.999) with optional global-norm clip and an exponential lr
    decay from `lr` to `lr_end` over `max_iter`."""

    def __init__(self, cfg: SceneTrainConfig):
        super().__init__(0.9, 0.999)
        self.base_lr = cfg.lr
        self.gamma = (cfg.lr_end / cfg.lr) ** (1.0 / cfg.max_iter)
        self.clip = cfg.nerf_gradient_clipping

    def lr(self, count) -> torch.Tensor:
        return self.base_lr * self.gamma ** torch.as_tensor(count)

    def update(self, grads, state):
        if self.clip:
            leaves = tree_leaves(grads)
            norm = torch.sqrt(sum((g * g).sum() for g in leaves))
            # t / norm * max_norm, the order optax uses
            leaves = [torch.where(norm < self.clip, g, g / norm * self.clip) for g in leaves]
            grads = tree_unflatten(grads, leaves)
        lr = self.lr(_count(state, tree_leaves(grads)[0]))
        return tree_unflatten(grads, [-(lr * x) for x in self._direction(grads, state)]), state


class PoseOptimizer(_Adam):
    """Adam (0.9, 0.99) with ExponentialLR from lr_pose to lr_pose_end over the
    pose window. With a separate translation window, the rotation dims
    (se3[..., :3]) and translation dims (se3[..., 3:]) decay over their own
    windows and freeze past them. `lr_pose <= 0` gives zero updates."""

    def __init__(self, cfg: ObjectTrainConfig, pose_window_steps: int,
                 trans_window_steps: int | None = None):
        super().__init__(0.9, 0.99)
        self.lr_pose, self.lr_pose_end = cfg.lr_pose, cfg.lr_pose_end
        self.rot_window = pose_window_steps
        self.split = not (trans_window_steps is None or trans_window_steps == pose_window_steps)
        self.trans_window = trans_window_steps if self.split else pose_window_steps

    def _gamma(self, window: int) -> float:
        return (self.lr_pose_end / (1e-10 + self.lr_pose)) ** (1.0 / max(window, 1))

    def _lr_window(self, count, window: int, freeze: bool) -> torch.Tensor:
        count = torch.as_tensor(count)
        lr = self.lr_pose * self._gamma(window) ** torch.clamp(count, max=window)
        return lr * (count < window) if freeze else lr

    def init(self, params):
        return None if self.lr_pose <= 0 else super().init(params)

    def update(self, grads, state):
        if self.lr_pose <= 0:
            return tree_map(torch.zeros_like, grads), state
        count = _count(state, tree_leaves(grads)[0])
        if not self.split:
            lr = self._lr_window(count, self.rot_window, freeze=False)
        else:
            lr_rot = self._lr_window(count, self.rot_window, freeze=True)
            lr_trans = self._lr_window(count, self.trans_window, freeze=True)
            lr = torch.stack([lr_rot] * 3 + [lr_trans] * 3)
        return tree_unflatten(grads, [-(x * lr) for x in self._direction(grads, state)]), state
