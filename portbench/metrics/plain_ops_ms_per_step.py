"""Device ms a training step of the events that are not the port's hand-written kernels (plain
torch ops, cuBLAS, copies, memsets), in the traced window."""
from portbench import readers


def read(ctx):
    return readers.plain_ops_ms_per_step(ctx)
