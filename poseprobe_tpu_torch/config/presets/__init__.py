"""The published presets: the port's copies of `poseprobe_tpu/config/presets/*`.

Each module's `get_config(...)` builds the port's `ExperimentConfig` with the
reference preset's values; the family presets (`dtu_scan`, `nerf_synthetic`,
`replica_scene`, `toy_scene`) pick a scene from their tables.
"""
