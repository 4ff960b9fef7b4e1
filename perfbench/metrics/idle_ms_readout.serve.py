"""The card's idle time in the traced window inside the spans of the
outputs' read back and the ``Target3DArray``'s assembly
(``d3d.detect.readback``, ``d3d.detect.assemble``), in ms a traced frame
(``core/spans.py``)."""

from perfbench.core import spans


def read(ctx):
    return spans.idle_ms(ctx, "readout")
