"""The trunk's least time (counted from the configuration's trunk calls) over the device time of
the trunk kernels, in a render cell's traced window, in percent."""
from portbench import readers


def read(ctx):
    return readers.trunk_roofline_pct(ctx)
