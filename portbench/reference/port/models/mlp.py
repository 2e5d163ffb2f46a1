"""Linear-layer init for the JAX-layout parameter dicts ({'w': [in, out], 'b': [out]}).

Port of `poseprobe_tpu/models/mlp.py` (`init_linear`, `init_mlp`,
`apply_mlp`), drawing from an explicit `torch.Generator`.
"""
from __future__ import annotations

import math

import torch


def init_linear(generator: torch.Generator, d_in: int, d_out: int,
                scheme: str = "xavier") -> dict:
    """One linear layer. ``xavier_relu`` / ``xavier``: tensorflow-style
    uniform init of the scene NeRF with / without the ReLU gain, zero bias;
    ``torch``: U(+-1/sqrt(fan_in)) weight and bias (the color MLP);
    ``kaiming_normal``: N(0, 2/fan_in) weight, zero bias (the deform net);
    ``zeros``: the deform net's last layer."""
    if scheme == "torch":
        bound = 1.0 / math.sqrt(d_in)
        w = (2.0 * torch.rand((d_in, d_out), generator=generator, dtype=torch.float32) - 1.0) * bound
        b = (2.0 * torch.rand(d_out, generator=generator, dtype=torch.float32) - 1.0) * bound
        return {"w": w, "b": b}
    if scheme == "kaiming_normal":
        w = torch.randn((d_in, d_out), generator=generator, dtype=torch.float32) * math.sqrt(2.0 / d_in)
        return {"w": w, "b": torch.zeros(d_out, dtype=torch.float32)}
    if scheme == "zeros":
        return {"w": torch.zeros((d_in, d_out), dtype=torch.float32),
                "b": torch.zeros(d_out, dtype=torch.float32)}
    if scheme == "xavier_relu":
        bound = math.sqrt(2.0) * math.sqrt(6.0 / (d_in + d_out))
    elif scheme == "xavier":
        bound = math.sqrt(6.0 / (d_in + d_out))
    else:
        raise ValueError(scheme)
    u = torch.rand((d_in, d_out), generator=generator, dtype=torch.float32)
    return {"w": (2.0 * u - 1.0) * bound, "b": torch.zeros(d_out, dtype=torch.float32)}


def init_mlp(generator: torch.Generator, dims, scheme: str = "torch",
             last_scheme: str | None = None) -> list:
    layers = []
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        s = last_scheme if (last_scheme is not None and i == len(dims) - 2) else scheme
        layers.append(init_linear(generator, d_in, d_out, s))
    return layers


def apply_mlp(layers: list, x: torch.Tensor, final_activation=None) -> torch.Tensor:
    """ReLU MLP; no activation on the last layer unless given."""
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if i < len(layers) - 1:
            x = torch.relu(x)
    if final_activation is not None:
        x = final_activation(x)
    return x
