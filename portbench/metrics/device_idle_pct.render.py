"""The share of a render cell's traced window that the union of device intervals leaves uncovered,
in percent."""
from portbench import readers


def read(ctx):
    return readers.idle_pct(ctx)
