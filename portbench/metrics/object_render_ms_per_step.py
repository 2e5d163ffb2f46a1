"""Device ms a training step under the object render's spans (`poseprobe.object.*`: ray samples
and the mask cache's compaction, the SDF field and its lookups, the colour head, compositing), forward
and backward, from eager steps of the cell (`spans.py`)."""
from portbench import spans


def read(ctx):
    return spans.device_ms(ctx, lambda k: k.startswith("poseprobe.object."))
