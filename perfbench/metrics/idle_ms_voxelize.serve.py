"""The card's idle time in the traced window inside the spans of the host
copy of the frame and the voxelizer (``d3d.detect.upload``,
``d3d.detect.voxelize``), in ms a traced frame (``core/spans.py``)."""

from perfbench.core import spans


def read(ctx):
    return spans.idle_ms(ctx, "voxelize")
