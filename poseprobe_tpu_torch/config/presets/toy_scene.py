"""Toy-desk scene family — one factory for every per-scene config shipped by
the reference (`configs/toy/{desk1,candy,dragon,face}.py`).

desk1 and candy delegate to their standalone presets (`toy_desk.py`,
`toy_candy.py`). dragon and face are built from the candy template with the
per-scene deltas extracted by diffing the reference configs:

- dragon (`our_desk_2_dragon`, `configs/toy/dragon.py`): same views/depth
  range as candy, its own probe bbox (`dragon.py:39-41`), incremental
  activation every 200 iterations (`dragon.py:49`), 15k object iterations.
- face (`configs/toy/face.py`): wider test split (`face.py:21`), its own
  bbox (`face.py:39-40`), incremental step 100 (`face.py:48`),
  `world_bound_scale=1.5` (`face.py:57`), k0/density TV at 0.01
  (`face.py:67-68`), and the object branch disabled (`face.py:63`
  `N_iters=-1` — never true for `step <= N_iters`, same regime as replica's
  `N_iters=1`; we use 1, the smallest schedule-valid value).
"""
from __future__ import annotations

import dataclasses

from .. import config as cfg_mod

from . import toy_candy, toy_desk

SCENES = ("desk1", "candy", "dragon", "face")


def _expanded(lo, hi, scale):
    shift = [(b - a) * (scale - 1) / 2 for a, b in zip(lo, hi)]
    return (tuple(a - s for a, s in zip(lo, shift)),
            tuple(b + s for b, s in zip(hi, shift)))


def get_config(scene: str = "desk1",
               datadir: str | None = None) -> cfg_mod.ExperimentConfig:
    datadir = datadir or "./data/toy_desk"
    if scene == "desk1":
        return toy_desk.get_config(datadir)
    if scene == "candy":
        return toy_candy.get_config(datadir)
    if scene == "dragon":
        lo, hi = (0.0, -0.05, 0.25), (0.3, 0.15, 0.5)      # dragon.py:40-41
        elo, ehi = _expanded(lo, hi, 1.25)
        base = toy_candy.get_config(datadir)
        return dataclasses.replace(
            base,
            expname="our_desk_2_dragon",
            data=dataclasses.replace(base.data, xyz_min=lo, xyz_max=hi),
            camera=dataclasses.replace(base.camera, incremental_step=200),
            object_model=dataclasses.replace(base.object_model,
                                             xyz_min=elo, xyz_max=ehi),
        )
    if scene == "face":
        lo, hi = (-0.15, -0.15, 0.5), (0.1, 0.1, 0.7)      # face.py:39-40
        elo, ehi = _expanded(lo, hi, 1.5)
        base = toy_candy.get_config(datadir)
        return dataclasses.replace(
            base,
            expname="face",
            world_bound_scale=1.5,
            data=dataclasses.replace(
                base.data, xyz_min=lo, xyz_max=hi,
                test_id=(0, 1, 2, 3) + tuple(range(58, 79))),  # face.py:21
            camera=dataclasses.replace(base.camera, incremental_step=100),
            object_model=dataclasses.replace(
                base.object_model, xyz_min=elo, xyz_max=ehi,
                N_iters=1, world_bound_scale=1.5),
            object_train=dataclasses.replace(
                base.object_train, N_iters=1,
                weight_tv_k0=0.01, weight_tv_density=0.01),  # face.py:67-68
        )
    raise KeyError(f"unknown toy scene {scene!r}; known: {SCENES}")
