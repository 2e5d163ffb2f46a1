"""PyTorch + CUDA port of `poseprobe_tpu` for one NVIDIA H100.

The JAX package `poseprobe_tpu` stays the reference; every module here ports
the module of the same path there and is held against it by the parity tests
in `tests/test_torch_port_*.py`. This package imports neither `jax` nor any
module of `poseprobe_tpu`.

Ported so far: the joint training step in its three phase programs -- early
(object branch + scene), coarse and mid (scene only) -- with the trainers
`train.trainer.JointTrainer` / `SceneTrainer` and `build_trainer()`, and the
hand-written Hopper kernels under `csrc/`: the fused 8x256 scene trunk
(`ops/fused_mlp.py`), the trilinear gather/scatter (`ops/grid.py`) and the
layout kernels (`ops/layout.py`). Still raising `NotImplementedError`: PnP
pose initialisation, depth consistency from fresh pixels, the TensoRF feature
grid, `use_pallas_composite`, and `weight_surface_projection > 0`. Host pose
events, evaluation, checkpoints, loaders and the CLIs are later slices
(`ROADMAP.md`).

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``. On a CUDA tensor each hand-written kernel launches (or the
wrapper raises); on a CPU tensor the wrapper runs the kernel's plain PyTorch
twin.
"""
