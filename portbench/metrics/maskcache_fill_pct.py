"""The in-mask share of the lanes the object render computes after the mask cache's compaction
(the program's `maskcache_fill`: the compacted mask's mean), over the eager steps that `spans.py`
profiles, in percent."""
from portbench import spans


def read(ctx):
    sp = spans.of(ctx)
    fill = None if sp is None else sp.values.get("maskcache_fill")
    return None if fill is None else 100.0 * fill
