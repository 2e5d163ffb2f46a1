"""Device ms a training step under the scene render's spans other than the trunk
(`poseprobe.scene.sample`, `.encode`, `.head`, `.composite`: sampling, encodings, colour head,
compositing), forward and the backward linked to them, from eager steps of the cell (`spans.py`)."""
from portbench import spans


def read(ctx):
    return spans.device_ms(ctx, lambda k: k.startswith("poseprobe.scene.") and k != "poseprobe.scene.trunk")
