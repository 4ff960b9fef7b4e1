"""Host calls that put work on the card (kernel launches, copies, sets)
started inside SECOND's sparse layers' spans (``d3d.second.middle``), a
traced frame. Nothing to read without the spans."""

from perfbench.families import second


def read(ctx):
    return second.span_launches(ctx, {second.MIDDLE})
