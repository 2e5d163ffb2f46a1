"""The published DTU preset at the CPU tests' size (16 + 16 samples), for the
render driver's configuration guard in the tests."""
import dataclasses

from poseprobe_tpu_torch.config.presets import dtu_generic


def get_config():
    cfg = dtu_generic.get_config()
    return dataclasses.replace(cfg, scene_model=dataclasses.replace(cfg.scene_model, sample_intvs=16,
                                                                    sample_intvs_fine=16))
