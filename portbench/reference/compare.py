"""The numbers that decide `correct`, each a gap between what the program
produced and what the reference computed from the same inputs.

Training: the loss of each checked step; the first gradient as the optimizer
gets it (read back from Adam's first moment after one step); the parameters'
change over the checked steps. Norms are compared by leaf, as the gap between
the program's norm and the reference's (not the norm of their difference),
over the larger of the reference leaf's norm and the median leaf's, since
some gradients are all but zero; the worst leaf is the number. A leaf whose
reference gradient is under a thousandth of the median leaf's moves under
Adam by round-off alone, and is left out of the change.
Rendering: the largest gap of a rendered ray's colour, depth (over the depth
range) and opacity, and their mean gaps.
"""
from __future__ import annotations

import statistics

EXCLUDE_BELOW = 1e-3


def loss_gap(program: list, reference: list) -> float:
    return max(abs(p - r) / max(abs(r), 1e-12) for p, r in zip(program, reference, strict=True))


def _worst(program: dict, reference: dict, keep) -> float:
    med = statistics.median(reference.values())
    gaps = [abs(program[k] - reference[k]) / max(reference[k], med, 1e-30) for k in reference if keep(k)]
    return max(gaps) if gaps else 0.0


def train_gaps(prog: dict, ref: dict) -> dict:
    """prog / ref: {"losses": [...], "grad_norms": {leaf: norm}, "change_norms": {leaf: norm}}."""
    if set(prog["grad_norms"]) != set(ref["grad_norms"]):
        raise ValueError("the program and the reference train other leaves: "
                         f"{sorted(set(prog['grad_norms']) ^ set(ref['grad_norms']))[:6]}")
    g_med = statistics.median(ref["grad_norms"].values())
    kept = {k for k, v in ref["grad_norms"].items() if v >= EXCLUDE_BELOW * g_med}
    steps = {f"loss_gap_{i + 1}": loss_gap([p], [r]) for i, (p, r) in enumerate(zip(prog["losses"], ref["losses"]))}
    return {**steps, "loss_gap": loss_gap(prog["losses"], ref["losses"]),
            "grad_gap": _worst(prog["grad_norms"], ref["grad_norms"], lambda k: True),
            "change_gap": _worst(prog["change_norms"], {k: ref["change_norms"][k] for k in kept},
                                 lambda k: True)}


def render_gaps(prog: dict, ref: dict, depth_range) -> dict:
    """prog / ref: {"rgb": [N, 3], "depth": [N, 1], "opacity": [N, 1]} tensors."""
    span = depth_range[1] - depth_range[0]
    d = {k: (prog[k].float() - ref[k].float()).abs() for k in ("rgb", "depth", "opacity")}
    return {"rgb_gap": float(d["rgb"].max()), "depth_gap": float(d["depth"].max()) / span,
            "opacity_gap": float(d["opacity"].max()), "rgb_mean_gap": float(d["rgb"].mean()),
            "depth_mean_gap": float(d["depth"].mean()) / span, "opacity_mean_gap": float(d["opacity"].mean())}
