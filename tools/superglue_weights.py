"""Write seeded SuperPoint / SuperGlue weights under the published
state_dict keys, as the ``.npz`` bundles `pose_init/convert.py` writes.

No pretrained weights come with the repository, so the matcher's path is
exercised with these: numpy draws from a seed, shaped so that the pipeline
does real work at its published settings (512 keypoints, match threshold
0.2). Weights at torch's default init make a flat heat map and descriptors
that are all alike (cosine ~0.9998), so that no match survives 0.2. Here:

* SuperPoint: He-scaled weights (U(-b, b), b = sqrt(6 / fan_in)) and zero
  biases, so that the image's texture survives the depth. The filters of
  ``conv1a`` (texture, not brightness) and of ``conv4a``, ``conv4b``,
  ``convDa`` and ``convDb`` sum to zero, so that the descriptors keep little
  common offset (mean cosine ~0.3 between two views' descriptors, against ~0.8
  without); zero-sum filters on every layer would cancel more and cost
  float32 digits. ``convPb`` is 10x (a peaked detector).
* SuperGlue: torch's default init, with the keypoint encoder's and every GNN
  layer's last convolution at 2% (small residual updates), ``final_proj`` a
  scaled identity (20 I plus 2% of its draw, no bias) and ``bin_score`` 6,
  so that similar descriptors match and the rest go to the dustbin. The
  scores stay within +-25, where float32 holds the log assignment to ~2e-5.

A view then matches a copy of itself shifted by a multiple of 8 pixels. The
matches between two views of a scene are not geometrically right: these
weights exercise the matcher and what consumes its packs, not matching
quality. BatchNorm statistics are drawn away from the identity so that
eval-mode BN does work. The keys are written out here from the published
architecture, independently of the port's modules, whose
``load_state_dict(strict=True)`` then checks their trees against them.

    python -m tools.superglue_weights --out DIR [--seed 0]
    export POSEPROBE_SUPERGLUE_WEIGHTS=DIR
"""
from __future__ import annotations

import argparse
import os

import numpy as np

_SP = (("conv1a", 1, 64, 3), ("conv1b", 64, 64, 3), ("conv2a", 64, 64, 3), ("conv2b", 64, 64, 3),
       ("conv3a", 64, 128, 3), ("conv3b", 128, 128, 3), ("conv4a", 128, 128, 3), ("conv4b", 128, 128, 3),
       ("convPa", 128, 256, 3), ("convPb", 256, 65, 1), ("convDa", 128, 256, 3), ("convDb", 256, 256, 1))
_ZERO_SUM = ("conv1a", "conv4a", "conv4b", "convDa", "convDb")


def _conv(rng, sd: dict, name: str, cin: int, cout: int, *kernel: int) -> None:
    bound = 1.0 / np.sqrt(cin * int(np.prod(kernel)))
    sd[f"{name}.weight"] = rng.uniform(-bound, bound, (cout, cin) + kernel).astype(np.float32)
    sd[f"{name}.bias"] = rng.uniform(-bound, bound, cout).astype(np.float32)


def _bn(rng, sd: dict, name: str, c: int) -> None:
    sd[f"{name}.weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    sd[f"{name}.bias"] = rng.uniform(-0.1, 0.1, c).astype(np.float32)
    sd[f"{name}.running_mean"] = rng.uniform(-0.1, 0.1, c).astype(np.float32)
    sd[f"{name}.running_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    sd[f"{name}.num_batches_tracked"] = np.asarray(0, np.int64)


def _mlp(rng, sd: dict, prefix: str, channels) -> None:
    """The published `MLP`: Conv1d at 3i, BatchNorm1d at 3i + 1 but the last."""
    for i in range(1, len(channels)):
        _conv(rng, sd, f"{prefix}.{3 * (i - 1)}", channels[i - 1], channels[i], 1)
        if i < len(channels) - 1:
            _bn(rng, sd, f"{prefix}.{3 * (i - 1) + 1}", channels[i])


def superpoint_state(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    sd: dict = {}
    for name, cin, cout, k in _SP:
        bound = np.sqrt(6.0 / (cin * k * k))
        w = rng.uniform(-bound, bound, (cout, cin, k, k))
        if name == "convPb":
            w *= 10.0
        elif name in _ZERO_SUM:
            w -= w.mean(axis=(1, 2, 3), keepdims=True)
        sd[f"{name}.weight"] = w.astype(np.float32)
        sd[f"{name}.bias"] = np.zeros(cout, np.float32)
    return sd


def _scale(sd: dict, name: str, factor: float) -> None:
    for leaf in ("weight", "bias"):
        sd[f"{name}.{leaf}"] = (sd[f"{name}.{leaf}"] * factor).astype(np.float32)


def superglue_state(seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    sd: dict = {}
    _mlp(rng, sd, "kenc.encoder", (3, 32, 64, 128, 256, 256))
    _scale(sd, "kenc.encoder.12", 0.02)
    for i in range(18):                       # 9 x (self, cross)
        p = f"gnn.layers.{i}"
        for j in range(3):
            _conv(rng, sd, f"{p}.attn.proj.{j}", 256, 256, 1)
        _conv(rng, sd, f"{p}.attn.merge", 256, 256, 1)
        _mlp(rng, sd, f"{p}.mlp", (512, 512, 256))
        _scale(sd, f"{p}.mlp.3", 0.02)
    _conv(rng, sd, "final_proj", 256, 256, 1)
    sd["final_proj.weight"] = (20.0 * np.eye(256)[:, :, None] + 0.02 * sd["final_proj.weight"]).astype(np.float32)
    sd["final_proj.bias"] = np.zeros(256, np.float32)
    sd["bin_score"] = np.asarray(6.0, np.float32)
    return sd


def write(out_dir: str, seed: int = 0) -> dict:
    """superpoint_v1.npz and superglue_indoor.npz in `out_dir`, through the
    port's `convert.save_npz`; returns their paths."""
    from poseprobe_tpu_torch.pose_init import convert

    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for stem, sd in (("superpoint_v1", superpoint_state(seed)), ("superglue_indoor", superglue_state(seed + 1))):
        paths[stem] = os.path.join(out_dir, stem + ".npz")
        convert.save_npz(paths[stem], sd)
    return paths


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    for stem, p in write(args.out, args.seed).items():
        print(f"{stem}: {p}")
    print(f"export POSEPROBE_SUPERGLUE_WEIGHTS={args.out}")


if __name__ == "__main__":
    main()
