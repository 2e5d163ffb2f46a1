"""A rendered band's model FLOPs (counted from the configuration) over the unprofiled window's time
and the H100's dense bf16 peak, in percent."""
from portbench import readers


def read(ctx):
    return readers.mfu_pct(ctx)
