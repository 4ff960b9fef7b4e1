"""Host calls that put work on the card (kernel launches, copies, sets)
started inside the spans of score, top-k, decode and NMS
(``d3d.detect.select``), a traced frame (``core/spans.py``)."""

from perfbench.core import spans


def read(ctx):
    return spans.launches(ctx, "select")
