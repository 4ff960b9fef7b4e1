from .pointpillars import (PointPillars, PointPillarsConfig, decode_boxes,
                           make_anchors, pillarize, scatter_to_bev)
from . import presets
from .inference import make_pointpillars_detector
from .convert import pointpillars_state_from_flax

__all__ = [
    "PointPillars", "PointPillarsConfig", "pillarize", "scatter_to_bev",
    "make_anchors", "decode_boxes", "presets", "make_pointpillars_detector",
    "pointpillars_state_from_flax",
]
