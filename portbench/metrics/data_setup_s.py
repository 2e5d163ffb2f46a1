"""Seconds of the benchmark's span around the cell's data and the program's construction (the
trainer, or the render's camera and config): loading, matching, feature maps, the PnP chain
where the cell has them."""


def read(ctx):
    return ctx.run.spans.get("data_setup_s")
