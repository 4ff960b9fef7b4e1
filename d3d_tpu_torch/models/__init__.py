from .pointpillars import (PointPillars, PointPillarsConfig, assign_targets,
                           decode_boxes, detection_loss, encode_boxes,
                           make_anchors, make_train_step, pillarize,
                           prepare_targets, scatter_to_bev)
from .centerpoint import (CenterPoint, CenterPointConfig,
                          assign_center_targets, center_loss, decode_centers)
from .centerpoint2 import (CenterPointRefine, RefineConfig,
                           apply_refinements, encode_refinement_targets,
                           make_refine_train_step, roi_grid_features)
from .seg2d import Seg2D, Seg2DConfig, make_segmenter
from .mono3d import (Mono3D, Mono3DConfig, assign_mono3d_targets,
                     decode_mono3d, make_mono3d_detector,
                     mono3d_gt_from_targets, mono3d_loss, mono3d_to_targets)
from .bevseg import (BEVSeg, BEVSegConfig, bevseg_pillarize,
                     group_instances, make_panoptic_predictor,
                     make_predictor, panoptic_loss, panoptic_targets,
                     point_cell_coords, segmentation_loss)
from .second import (SECOND, SECONDConfig, SECONDLayout, head_config,
                     second_voxelize, sparse_stage_loop)
from .voxelnext import (VoxelNeXt, VoxelNeXtConfig, decode_voxelnext,
                        voxelnext_voxelize)
from .sst import SST, SSTConfig, window_slots
from . import presets
from .inference import (make_centerpoint_detector,
                        make_pointpillars_detector, make_second_detector,
                        make_sst_detector, make_voxelnext_detector)
from .tta import make_tta_detector
from .convert import (bevseg_params_from_flax, bevseg_state_from_flax,
                      centerpoint_params_from_flax,
                      centerpoint_refine_state_from_flax,
                      centerpoint_state_from_flax,
                      pointpillars_params_from_flax,
                      pointpillars_state_from_flax, second_params_from_flax,
                      mono3d_params_from_flax, mono3d_state_from_flax,
                      second_state_from_flax, seg2d_params_from_flax,
                      seg2d_state_from_flax, sst_params_from_flax,
                      sst_state_from_flax, voxelnext_params_from_flax,
                      voxelnext_state_from_flax)

__all__ = [
    "PointPillars", "PointPillarsConfig", "pillarize", "scatter_to_bev",
    "make_anchors", "decode_boxes", "encode_boxes", "assign_targets",
    "detection_loss", "prepare_targets", "CenterPoint", "CenterPointConfig",
    "assign_center_targets", "center_loss", "decode_centers",
    "CenterPointRefine", "RefineConfig", "roi_grid_features",
    "apply_refinements", "encode_refinement_targets",
    "make_refine_train_step", "Seg2D", "Seg2DConfig", "make_segmenter",
    "SECOND", "SECONDConfig", "SECONDLayout",
    "head_config", "second_voxelize", "sparse_stage_loop", "make_train_step",
    "presets", "make_pointpillars_detector", "make_centerpoint_detector",
    "make_second_detector",
    "make_tta_detector", "VoxelNeXt", "VoxelNeXtConfig",
    "voxelnext_voxelize", "decode_voxelnext", "make_voxelnext_detector",
    "pointpillars_state_from_flax", "pointpillars_params_from_flax",
    "centerpoint_state_from_flax", "centerpoint_params_from_flax",
    "centerpoint_refine_state_from_flax", "seg2d_state_from_flax",
    "seg2d_params_from_flax", "second_state_from_flax",
    "second_params_from_flax", "voxelnext_state_from_flax",
    "voxelnext_params_from_flax", "Mono3D", "Mono3DConfig",
    "assign_mono3d_targets", "mono3d_loss", "decode_mono3d",
    "mono3d_to_targets", "make_mono3d_detector", "mono3d_gt_from_targets",
    "BEVSeg", "BEVSegConfig", "bevseg_pillarize", "point_cell_coords",
    "segmentation_loss", "panoptic_targets", "panoptic_loss",
    "group_instances", "make_predictor", "make_panoptic_predictor",
    "mono3d_state_from_flax", "mono3d_params_from_flax",
    "bevseg_state_from_flax", "bevseg_params_from_flax", "SST",
    "SSTConfig", "window_slots", "make_sst_detector", "sst_state_from_flax",
    "sst_params_from_flax",
]
