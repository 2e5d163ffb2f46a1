"""PyTorch + CUDA port of `poseprobe_tpu` for one NVIDIA H100.

The JAX package `poseprobe_tpu` stays the reference; every module here ports
the module of the same path there and is held against it by the parity tests
in `tests/test_torch_port_*.py`. This package imports neither `jax` nor any
module of `poseprobe_tpu`.

Ported so far: the joint training step in its three phase programs -- early
(object branch + scene), coarse and mid (scene only) -- with the trainers
`train.trainer.JointTrainer` / `SceneTrainer` and `build_trainer()`; the host
loop `JointTrainer.fit` with PnP pose seeding (`pose_init/pnp.py`) and the
host pose events (view activation with its gates, warmup and rescue, BA
polish, re-registration, probe health, the chord-K re-bound; `core/align.py`,
`pose_init/ba.py`, `pose_init/relpose.py`, the trainer-facing part of
`eval/evaluator.py`); and the hand-written Hopper kernels under `csrc/`: the
fused 8x256 scene trunk (`ops/fused_mlp.py`), the trilinear gather/scatter
(`ops/grid.py`), the layout kernels (`ops/layout.py`), the scene encoding
written into the trunk's input tile (`ops/pe.py` `posenc_scene_padded`) and
the fused alpha-composite, forward and backward (`ops/fused_composite.py`). The
published presets train from data on disk: the full configuration and its
presets (`config/`), the six dataset loaders with their PNG reader and the
classical matcher (`data/loaders.py`, `data/png.py`, `pose_init/matching.py`),
and the surface-feature loss with its feature maps and the image metrics
(`losses/projection.py`, `eval/vgg_features.py`, `eval/metrics.py`). After
training: checkpoints in the JAX package's format v2 (`train/state.py`, the
trainer's `host_extras`), the full test-set evaluation
(`eval/evaluator.evaluate_full`), mesh export (`models/object_sdf`'s
`extract_sdf_volume` / `mesh_color_forward`, `eval/mesh.py` over the native
library `native/mesh_native.cpp`, `eval/dtu_protocol.py`), video export
(`eval/video.py`, `eval/turbo.py`), `utils/`, and the two CLIs
(`python -m poseprobe_tpu_torch.run`, `python -m poseprobe_tpu_torch.evaluate`).
The rest of the single-card paths: the TensoRF feature grid (`ops/tensorf.py`,
``grid_type="tensorf"``), depth consistency from fresh pixels (the step with
the corres term off), the SuperPoint + SuperGlue matcher and its weight
converter (`pose_init/superglue.py`, `pose_init/convert.py`), the mask
cache's even windows and the 3-D smoothing kernel. The parallel package
(`parallel/`, on `torch.distributed`, one process per rank): ray data
parallelism for the trainers (``mesh=``), Z-sharded grids with a halo plane
and the sharded object and joint steps, and the process-group set-up.
OpenCV is optional: without it PnP runs a numpy RANSAC, the BA
polish and the match refinement decline, and the classical matcher returns
empty packs.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``. On a CUDA tensor each hand-written kernel launches (or the
wrapper raises); on a CPU tensor the wrapper runs the kernel's plain PyTorch
twin.
"""
