"""Device ms a training step whose innermost span is a loss group (`poseprobe.step.scene_losses`,
`.depth_cons`, `.object_losses`, `.projection`, `.feature`; the renders nested in them count with
the renders), forward and backward, from eager steps of the cell (`spans.py`)."""
from portbench import spans

LOSSES = {f"poseprobe.step.{g}" for g in ("scene_losses", "depth_cons", "object_losses", "projection", "feature")}


def read(ctx):
    return spans.device_ms(ctx, LOSSES.__contains__)
