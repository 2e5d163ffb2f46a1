"""Device ms a rendered band under the scene render's spans other than the trunk
(`poseprobe.scene.sample`, `.encode`, `.head`, `.composite`), from a profiled band (`spans.py`)."""
from portbench import spans


def read(ctx):
    return spans.device_ms(ctx, lambda k: k.startswith("poseprobe.scene.") and k != "poseprobe.scene.trunk")
