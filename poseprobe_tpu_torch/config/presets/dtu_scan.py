"""DTU scan family — one factory for every per-scan config shipped by the
reference (`configs/dtu_e2e/scan{1,2,4,5,6,30,83,105,114}.py`).

The per-scan deltas are only: object bbox (probe-object size), near/far,
PnP on/off, and the VGG surface-feature-loss weight; everything else is the
shared scan1/coarse template. Seed = scan id (`define_trainer.py:62-63`).
"""
from __future__ import annotations

import dataclasses

from .. import config as cfg_mod

from . import dtu_scan1

# scan id -> (near, far, xyz_min, xyz_max, use_pnp, ransac, N_iters, w_surface_proj)
# from the per-scan configs; scan1 = `scan1.py`, others = `scan<k>.py` deltas
SCAN_TABLE: dict[int, tuple] = {
    1:   (0.3, 4.0, (-0.4, -0.4, -0.5),   (0.4, 0.4, 0.3),  True,  True,  10000, 0.0),
    2:   (1.0, 5.0, (-0.55, -0.3, -0.5),  (0.25, 0.5, 0.3), False, True,  15000, 0.001),
    4:   (1.0, 5.0, (-0.25, -0.2, -0.5),  (0.25, 0.4, 0.3), False, True,  15000, 0.0),
    5:   (1.0, 5.0, (-0.1, -0.1, -0.5),   (0.4, 0.4, 0.0),  False, True,  15000, 0.0),
    6:   (1.0, 5.0, (-0.35, -0.35, -0.35), (0.35, 0.35, 0.35), False, True, 15000, 0.001),
    30:  (1.0, 5.0, (-0.2, -0.35, -0.5),  (0.6, 0.35, 0.3), False, False, 15000, 0.001),
    83:  (1.0, 5.0, (-0.2, -0.35, -0.5),  (0.6, 0.35, 0.3), False, False, 15000, 0.001),
    105: (1.0, 5.0, (-0.55, -0.2, -0.5),  (0.25, 0.6, 0.3), False, True,  15000, 0.001),
    114: (0.3, 5.0, (-0.5, -0.4, -0.4),   (0.1, 0.4, 0.4),  False, True,  15000, 0.001),
}


def _expanded(lo, hi, scale):
    shift = [(b - a) * (scale - 1) / 2 for a, b in zip(lo, hi)]
    return (tuple(a - s for a, s in zip(lo, shift)),
            tuple(b + s for b, s in zip(hi, shift)))


def get_config(scan_id: int = 1, datadir: str | None = None) -> cfg_mod.ExperimentConfig:
    if scan_id not in SCAN_TABLE:
        raise KeyError(f"unknown DTU scan {scan_id}; known: {sorted(SCAN_TABLE)}")
    near, far, lo, hi, use_pnp, ransac, n_iters, w_sp = SCAN_TABLE[scan_id]
    base = dtu_scan1.get_config(datadir or f"./data/DTU/scan{scan_id}")
    elo, ehi = _expanded(lo, hi, base.world_bound_scale)
    return dataclasses.replace(
        base,
        expname=f"scan{scan_id}",
        seed=scan_id,  # DTU seed = scan id (define_trainer.py:62-63)
        data=dataclasses.replace(base.data, near=near, far=far,
                                 xyz_min=lo, xyz_max=hi),
        pnp=cfg_mod.PnPConfig(use_pnp=use_pnp, ransac=ransac),
        object_model=dataclasses.replace(base.object_model, xyz_min=elo,
                                         xyz_max=ehi, N_iters=n_iters),
        object_train=dataclasses.replace(base.object_train, N_iters=n_iters,
                                         weight_surface_projection=w_sp),
    )
