"""Seconds the program's GraphCache spent capturing the cell's step graph (StepGraph.capture_s)."""


def read(ctx):
    return ctx.run.values.get("graph_capture_s")
