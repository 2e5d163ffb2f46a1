"""The trilinear lookups' least time from bytes (points as the cell's chord-bound samples need
them) over the device time of the trilinear kernels, in percent."""
from portbench import readers


def read(ctx):
    return readers.grid_roofline_pct(ctx)
