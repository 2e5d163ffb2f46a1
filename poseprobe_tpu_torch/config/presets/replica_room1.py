"""Replica room1 — mirror of `configs/replica/room1.py`.

Identical to the room0 protocol (object branch off after one step, GT-seeded
poses, incremental activation every 2000 iterations); only the scene name and
the selected views differ (`room1.py:14,18`: selected_id = [300, 350, 400]).
"""
import dataclasses

from .. import config as cfg_mod

from . import replica_room0


def get_config(datadir: str = "./data/Replica") -> cfg_mod.ExperimentConfig:
    base = replica_room0.get_config(datadir)
    return dataclasses.replace(
        base,
        expname="room1",
        data=dataclasses.replace(base.data, selected_id=(300, 350, 400)),
    )
