"""Device ms a training step under `poseprobe.step.optimizer` (Adam's in-place updates and the step
counter's advance), from eager steps of the cell (`spans.py`)."""
from portbench import spans


def read(ctx):
    return spans.device_ms(ctx, "poseprobe.step.optimizer".__eq__)
