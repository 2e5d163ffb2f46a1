"""Replica scene family — one factory for every per-scene config shipped by
the reference (`configs/replica/{office0..3,room0..2}.py`).

The per-scene configs are byte-identical except for the experiment name and
the three selected training views (verified by diff); everything else is the
shared room0 protocol (object branch off after one step, GT-seeded poses,
incremental activation every 2000 iterations).
"""
from __future__ import annotations

import dataclasses

from .. import config as cfg_mod

from . import replica_room0

# scene -> selected_id, from `configs/replica/<scene>.py:14-18`
SCENE_TABLE: dict[str, tuple[int, int, int]] = {
    "office0": (100, 150, 200),
    "office1": (200, 300, 400),
    "office2": (100, 150, 200),
    "office3": (0, 350, 700),
    "room0": (0, 250, 500),
    "room1": (300, 350, 400),
    "room2": (0, 100, 200),
}


def get_config(scene: str = "room0",
               datadir: str | None = None) -> cfg_mod.ExperimentConfig:
    if scene not in SCENE_TABLE:
        raise KeyError(f"unknown Replica scene {scene!r}; known: {sorted(SCENE_TABLE)}")
    base = replica_room0.get_config(datadir or "./data/Replica")
    return dataclasses.replace(
        base,
        expname=scene,
        data=dataclasses.replace(base.data, selected_id=SCENE_TABLE[scene]),
    )
