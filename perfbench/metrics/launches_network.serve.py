"""Host calls that put work on the card (kernel launches, copies, sets)
started inside the network's spans (``d3d.detect.network``), a traced
frame (``core/spans.py``)."""

from perfbench.core import spans


def read(ctx):
    return spans.launches(ctx, "network")
