"""NeRF-synthetic-with-ShapeNet family — one factory for every per-scene
config shipped by the reference (`configs/nerf_synthetic_e2e/*.py`:
bedroom, cole, cole2, desk_car, hat, keyboard, soft_bedroom).

The seven per-scene configs are identical except for the experiment name and
the three selected training views (verified by grep/diff: same datadir
category 02958343, bbox, near/far, PnP-off, 15k object iterations,
`weight_surface_projection=0.001`); everything else is the shared desk_car
template (`presets/shapenet_car.py`).
"""
from __future__ import annotations

import dataclasses

from .. import config as cfg_mod

from . import shapenet_car

# scene -> (expname, selected_id), from `configs/nerf_synthetic_e2e/<scene>.py`
SCENE_TABLE: dict[str, tuple[str, tuple[int, int, int]]] = {
    "bedroom": ("bedroom", (35, 45, 55)),          # bedroom.py:12
    "cole": ("cole", (50, 65, 80)),                # cole.py:13
    "cole2": ("cole_2", (20, 30, 40)),             # cole2.py:10,14
    "desk_car": ("desk_car", (80, 95, 10)),        # desk_car.py:14
    "hat": ("hat", (80, 90, 0)),                   # hat.py:14
    "keyboard": ("keyboard", (45, 55, 65)),        # keyboard.py:14
    "soft_bedroom": ("soft_bedroom", (95, 10, 20)),  # soft_bedroom.py:14
}


def get_config(scene: str = "desk_car",
               datadir: str | None = None) -> cfg_mod.ExperimentConfig:
    if scene not in SCENE_TABLE:
        raise KeyError(
            f"unknown nerf_synthetic scene {scene!r}; known: {sorted(SCENE_TABLE)}")
    expname, selected = SCENE_TABLE[scene]
    base = shapenet_car.get_config(datadir or "./data/scene_with_shape/02958343")
    return dataclasses.replace(
        base,
        expname=expname,
        data=dataclasses.replace(base.data, selected_id=selected),
    )
