"""Visualization helpers (port of ``d3d_tpu.vis``; reference d3d/vis): matplotlib image/BEV overlays,
3D point-cloud viewers (pcl.py optional) and XVIZ streaming (optional)."""

from . import image  # matplotlib is baked in

__all__ = ["image"]
