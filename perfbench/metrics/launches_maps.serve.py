"""Host calls that put work on the card (kernel launches, copies, sets)
started inside SECOND's map spans (``d3d.second.maps``: neighbour maps,
downsampling and rule books), a traced frame. Nothing to read without the
spans."""

from perfbench.families import second


def read(ctx):
    return second.span_launches(ctx, {second.MAPS})
