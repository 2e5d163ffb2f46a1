"""The weights of a cell, made by the benchmark from the seed on the device.

`make(template, seed, device, box)` fills a tree shaped like `template` (the
program's parameter tree, whose shapes alone are read) with values drawn in
one call of a device `torch.Generator` seeded with `seed`, scaled per leaf by
its kind, as the model's own inits scale them:
* a matrix [in, out] (`w`): uniform, the ReLU-gained Xavier bound;
* a bias (`b`): uniform +-0.01;
* the SDF grid [1, X, Y, Z]: a sphere's signed distance (radius half the
  object box's half-width) over the grid's voxel centres, plus uniform +-0.01;
* a feature grid [C, X, Y, Z] (`k0_grid`): uniform +-0.1;
* the pose refinements (`se3_*`): zeros, where refinement starts;
* a 0-dim leaf: the value the table below gives it by name.
The same tree goes to the program (copied into its tensors in place) and to
the reference.
"""
from __future__ import annotations

import math

import torch

from .reference.port.core.tree import tree_unflatten

SCALARS = {"sdf_alpha": 10.0, "sdf_beta": 2.0, "s_val": 0.2, "output_range": 0.1}


def named_leaves(tree, prefix: str = "") -> list:
    """[(path, leaf)] in the order `tree_leaves` visits them (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in named_leaves(tree[k], f"{prefix}.{k}" if prefix else str(k))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in named_leaves(v, f"{prefix}.{i}")]
    return [(prefix, tree)]


def _sphere(shape, box, device) -> torch.Tensor:
    lo, hi = box
    axes = [torch.linspace(float(lo[i]), float(hi[i]), shape[i + 1], device=device) for i in range(3)]
    x, y, z = torch.meshgrid(*axes, indexing="ij")
    r = 0.5 * min((float(hi[i]) - float(lo[i])) / 2 for i in range(3))
    return (torch.sqrt(x * x + y * y + z * z) - r)[None]


def make(template: dict, seed: int, device, box=None) -> dict:
    """A tree of float32 tensors shaped like `template` (see the module's docstring);
    `box` = (xyz_min, xyz_max) of the object grid, where the tree has one."""
    named = named_leaves(template)
    total = sum(t.numel() for _, t in named)
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0          # one draw, in [-1, 1)
    out, at = [], 0
    for path, t in named:
        v, at = u[at:at + t.numel()].view(t.shape), at + t.numel()
        key = path.split(".")[-1]
        if t.dim() == 0:
            if key not in SCALARS:
                raise KeyError(f"no value for the scalar leaf {path}")
            out.append(torch.full((), SCALARS[key], dtype=torch.float32, device=device))
        elif key == "w":
            out.append(v * math.sqrt(2.0) * math.sqrt(6.0 / (t.shape[0] + t.shape[1])))
        elif key == "b":
            out.append(v * 0.01)
        elif key == "sdf_grid":
            out.append(_sphere(t.shape, box, device) + 0.01 * v)
        elif key == "k0_grid":
            out.append(v * 0.1)
        elif key.startswith("se3_"):
            out.append(torch.zeros(t.shape, dtype=torch.float32, device=device))
        else:
            raise KeyError(f"no rule for the leaf {path} {tuple(t.shape)}")
    return tree_unflatten(template, [x.contiguous() for x in out])


def load_into(program_tree: dict, values: dict) -> None:
    """Copy `values` into the program's tensors in place (their addresses stay)."""
    with torch.no_grad():
        for (pa, a), (pb, b) in zip(named_leaves(program_tree), named_leaves(values), strict=True):
            if pa != pb or a.shape != b.shape:
                raise ValueError(f"the program's leaf {pa} {tuple(a.shape)} is not {pb} {tuple(b.shape)}")
            a.copy_(b)
