"""Pretrained-weights converter: torch ``.pth`` checkpoints -> portable ``.npz``.

Port of `poseprobe_tpu/pose_init/convert.py`. The SuperPoint / SuperGlue
weights ship as torch state_dicts, the LPIPS(vgg) weights come from
torchvision and the ``lpips`` package. This CLI converts them once into flat
``.npz`` bundles, one array per parameter under its state_dict key:

    python -m poseprobe_tpu_torch.pose_init.convert --pth superpoint_v1.pth --out superpoint_v1.npz
    python -m poseprobe_tpu_torch.pose_init.convert --pth-dir /weights --out-dir /weights_npz
    python -m poseprobe_tpu_torch.pose_init.convert --lpips --out lpips_vgg.npz   # needs torchvision+lpips

`pose_init/superglue.py` loads either form into its modules with
``load_state_dict(strict=True)``.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def state_dict_to_arrays(sd: dict) -> dict[str, np.ndarray]:
    """Flatten a torch state_dict (or any str -> tensor/array map) to numpy."""
    return {str(k): v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
            for k, v in sd.items()}


def save_npz(path: str, sd: dict) -> None:
    np.savez(path, **state_dict_to_arrays(sd))


def load_npz(path: str) -> dict[str, np.ndarray]:
    """A converted bundle as the flat {state_dict key: array} it holds."""
    with np.load(path) as blobs:
        return {k: blobs[k] for k in blobs.files}


def read_pth(pth_path: str) -> dict[str, np.ndarray]:
    """A ``.pth`` state_dict (or a dict holding one under ``state_dict``),
    read with ``weights_only=True``, as numpy arrays."""
    sd = torch.load(pth_path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd and all(
            hasattr(v, "detach") for v in sd["state_dict"].values()):
        sd = sd["state_dict"]
    return state_dict_to_arrays(sd)


def convert_pth(pth_path: str, out_path: str) -> dict[str, np.ndarray]:
    """`read_pth`, written to `out_path` as ``.npz``."""
    arrays = read_pth(pth_path)
    np.savez(out_path, **arrays)
    return arrays


def convert_lpips(out_path: str) -> dict[str, np.ndarray]:
    """The LPIPS(vgg-lin) bundle: torchvision VGG16 ``features.N.weight/bias``
    and lpips ``lin{i}.model.1.weight``. Needs torchvision and lpips; no
    path of the package reads the bundle."""
    import lpips as lpips_pkg
    import torchvision

    vgg = torchvision.models.vgg16(weights="IMAGENET1K_V1")
    net = lpips_pkg.LPIPS(net="vgg")
    sd = {f"features.{k}": v for k, v in vgg.features.state_dict().items()}
    for i, lin in enumerate(net.lins):
        sd[f"lin{i}.model.1.weight"] = lin.model[1].weight
    with torch.no_grad():
        arrays = state_dict_to_arrays(sd)
    np.savez(out_path, **arrays)
    return arrays


KNOWN_PTH = ("superpoint_v1.pth", "superglue_indoor.pth", "superglue_outdoor.pth")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pth", help="single torch checkpoint to convert")
    ap.add_argument("--out", help="output .npz path")
    ap.add_argument("--pth-dir", help="directory with the known SuperPoint/SuperGlue .pth files")
    ap.add_argument("--out-dir", help="output directory for --pth-dir mode")
    ap.add_argument("--lpips", action="store_true",
                    help="build the LPIPS(vgg) bundle from torchvision+lpips packages")
    args = ap.parse_args(argv)

    if args.lpips:
        out = args.out or "lpips_vgg.npz"
        arrays = convert_lpips(out)
        print(f"wrote {out} ({len(arrays)} arrays)")
        return 0
    if args.pth:
        out = args.out or os.path.splitext(args.pth)[0] + ".npz"
        arrays = convert_pth(args.pth, out)
        print(f"wrote {out} ({len(arrays)} arrays)")
        return 0
    if args.pth_dir:
        out_dir = args.out_dir or args.pth_dir
        os.makedirs(out_dir, exist_ok=True)
        n = 0
        for name in KNOWN_PTH:
            src = os.path.join(args.pth_dir, name)
            if not os.path.exists(src):
                continue
            dst = os.path.join(out_dir, os.path.splitext(name)[0] + ".npz")
            arrays = convert_pth(src, dst)
            print(f"wrote {dst} ({len(arrays)} arrays)")
            n += 1
        if n == 0:
            print(f"no known checkpoints found in {args.pth_dir} (expected any of {KNOWN_PTH})")
            return 1
        return 0
    ap.print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
