"""Device-idle ms a rendered band while the innermost span open on the host is the render loop's
(`poseprobe.render.*`) or the scene render's (`poseprobe.scene.*`), from a profiled band (`spans.py`)."""
from portbench import spans


def read(ctx):
    sp = spans.of(ctx)
    if sp is None:
        return None
    hits = [v for k, v in sp.idle_ms.items() if k.startswith(("poseprobe.render.", "poseprobe.scene."))]
    return sum(hits) if hits else None
