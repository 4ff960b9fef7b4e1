from .pointpillars import (PointPillars, PointPillarsConfig, decode_boxes,
                           make_anchors, pillarize, scatter_to_bev)
from .second import (SECOND, SECONDConfig, head_config, second_voxelize,
                     sparse_stage_loop)
from . import presets
from .inference import make_pointpillars_detector, make_second_detector
from .convert import pointpillars_state_from_flax, second_state_from_flax

__all__ = [
    "PointPillars", "PointPillarsConfig", "pillarize", "scatter_to_bev",
    "make_anchors", "decode_boxes", "SECOND", "SECONDConfig", "head_config",
    "second_voxelize", "sparse_stage_loop", "presets",
    "make_pointpillars_detector", "make_second_detector",
    "pointpillars_state_from_flax", "second_state_from_flax",
]
