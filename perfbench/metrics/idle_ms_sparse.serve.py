"""The card's idle time in the traced window inside SECOND's sparse path,
the maps' and the sparse layers' spans (``d3d.second.maps``,
``d3d.second.middle``), in ms a traced frame. Nothing to read without the
spans."""

from perfbench.families import second


def read(ctx):
    return second.span_idle_ms(ctx, {second.MAPS, second.MIDDLE})
