"""The card's idle time in the traced window inside the spans of score,
top-k, decode and NMS (``d3d.detect.select``), in ms a traced frame
(``core/spans.py``)."""

from perfbench.core import spans


def read(ctx):
    return spans.idle_ms(ctx, "select")
