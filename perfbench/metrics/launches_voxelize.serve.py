"""Host calls that put work on the card (kernel launches, copies, sets)
started inside the spans of the host copy of the frame and the voxelizer
(``d3d.detect.upload``, ``d3d.detect.voxelize``), a traced frame
(``core/spans.py``)."""

from perfbench.core import spans


def read(ctx):
    return spans.launches(ctx, "voxelize")
