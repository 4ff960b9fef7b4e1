"""The card's idle time in the traced window inside the network's spans
(``d3d.detect.network``), in ms a traced frame (``core/spans.py``)."""

from perfbench.core import spans


def read(ctx):
    return spans.idle_ms(ctx, "network")
