"""Ready-made model configurations (port of ``d3d_tpu.models.presets``).

Ported so far: the KITTI PointPillars, SECOND and Mono3D presets, the
nuScenes and Waymo CenterPoint presets, nuScenes VoxelNeXt, the
SemanticKITTI BEV segmentation preset and KITTI SST. Like the JAX
package's, they default to ``bfloat16`` compute; pass ``dtype="float32"``
to override.
"""

from dataclasses import replace

from .bevseg import BEVSegConfig
from .centerpoint import CenterPointConfig
from .mono3d import Mono3DConfig
from .pointpillars import PointPillarsConfig
from .second import SECONDConfig
from .sst import SSTConfig
from .voxelnext import VoxelNeXtConfig

__all__ = ["pointpillars_kitti", "pointpillars_kitti_3class",
           "centerpoint_nuscenes", "centerpoint_nuscenes_10sweep",
           "centerpoint_waymo", "second_kitti", "mono3d_kitti",
           "voxelnext_nuscenes", "bevseg_semantickitti", "sst_kitti"]

# KITTI car/pedestrian/cyclist anchor sizes (l, w, h) from the
# PointPillars paper (Lang et al., CVPR 2019, Sec. 4.1)
_KITTI_CAR = (3.9, 1.6, 1.56)
_KITTI_PED = (0.8, 0.6, 1.73)
_KITTI_CYC = (1.76, 0.6, 1.73)


def pointpillars_kitti(**overrides):
    """Single-class (car) KITTI PointPillars: 0.16 m pillars, 432x496."""
    cfg = PointPillarsConfig(
        bounds=(0.0, 69.12, -39.68, 39.68, -3.0, 1.0), grid=(432, 496),
        max_pillars=12000, max_points_per_pillar=32, pfn_features=64,
        backbone_channels=(64, 128, 256), backbone_blocks=(3, 5, 5),
        upsample_channels=128, num_classes=1, anchor_sizes=(_KITTI_CAR,),
        pos_iou=0.6, neg_iou=0.45, dtype="bfloat16")
    return replace(cfg, **overrides)


def pointpillars_kitti_3class(**overrides):
    """Three-class KITTI PointPillars (car/pedestrian/cyclist anchors)."""
    cfg = pointpillars_kitti(
        num_classes=3, anchor_sizes=(_KITTI_CAR, _KITTI_PED, _KITTI_CYC),
        pos_iou=0.5, neg_iou=0.35)
    return replace(cfg, **overrides)


def centerpoint_nuscenes(**overrides):
    """nuScenes-scale CenterPoint: 0.2 m pillars over a 102.4 m square."""
    cfg = CenterPointConfig(
        bounds=(-51.2, 51.2, -51.2, 51.2, -5.0, 3.0), grid=(512, 512),
        dtype="bfloat16")
    return replace(cfg, **overrides)


def centerpoint_nuscenes_10sweep(**overrides):
    """nuScenes 10-sweep temporal CenterPoint: the keyframe cloud plus 9
    motion-compensated sweeps with an age channel (build the input with
    :func:`d3d_tpu_torch.models.sweeps.accumulate_sweeps`; the extra dt
    column flows through pillarize into the PFN). The 5x pillar budget
    (60k vs the base preset's 12k) absorbs the ~10x point count (sweeps
    mostly densify already-occupied cells). The velocity head is on: the
    decoded velocities feed the tracker (the official nuScenes
    CenterPoint configuration)."""
    cfg = CenterPointConfig(
        bounds=(-51.2, 51.2, -51.2, 51.2, -5.0, 3.0), grid=(512, 512),
        max_pillars=60000, max_points_per_pillar=20,
        predict_velocity=True, dtype="bfloat16")
    return replace(cfg, **overrides)


def centerpoint_waymo(**overrides):
    """Waymo-scale CenterPoint: 0.32 m pillars over a 150 m square, 3
    classes (vehicle/pedestrian/cyclist). Waymo labels 360-degree
    heading; the velocity head is off by default (single-frame input;
    set ``predict_velocity=True`` for multi-sweep clouds)."""
    cfg = CenterPointConfig(
        bounds=(-75.2, 75.2, -75.2, 75.2, -2.0, 4.0), grid=(470, 470),
        max_pillars=32000, max_points_per_pillar=20, num_classes=3,
        dtype="bfloat16")
    return replace(cfg, **overrides)


def second_kitti(**overrides):
    """KITTI SECOND: 0.2 m voxels, 20 z-layers, sparse middle extractor."""
    cfg = SECONDConfig(
        bounds=(0.0, 70.4, -40.0, 40.0, -3.0, 1.0), grid=(352, 400, 20),
        max_voxels=16000, stage_channels=(16, 32, 64),
        stage_sites=(16000, 8000, 4000), subm_per_stage=2,
        head_channels=128, num_classes=1, anchor_sizes=(_KITTI_CAR,),
        dtype="bfloat16")
    return replace(cfg, **overrides)


def mono3d_kitti(**overrides):
    """KITTI monocular 3D (SMOKE recipe): 384x1280 resized images,
    stride-4 heads, car/ped/cyclist dimension priors."""
    cfg = Mono3DConfig(
        image_size=(384, 1280), stride=4,
        backbone_channels=(32, 64, 128, 256), head_channels=64,
        num_classes=3, top_k=50, dtype="bfloat16")
    return replace(cfg, **overrides)


def voxelnext_nuscenes(**overrides):
    """nuScenes VoxelNeXt: 0.1 m voxels over the 108 m square, 10
    classes, velocity head on (the paper's detection-and-tracking
    configuration); fully sparse, so the long-range grid costs active
    sites, not canvas memory."""
    cfg = VoxelNeXtConfig(
        bounds=(-54.0, 54.0, -54.0, 54.0, -5.0, 3.0),
        grid=(1080, 1080, 40), max_voxels=60000,
        stage_channels=(16, 32, 64, 128),
        stage_sites=(60000, 30000, 15000, 8000), subm_per_stage=2,
        bev_sites=8000, head_channels=128, num_classes=10, top_k=200,
        predict_velocity=True, dtype="bfloat16")
    return replace(cfg, **overrides)


def bevseg_semantickitti(**overrides):
    """SemanticKITTI-style BEV segmentation: 19 classes + unlabeled."""
    cfg = BEVSegConfig(
        bounds=(-48.0, 48.0, -48.0, 48.0, -3.0, 1.8), grid=(480, 480),
        max_pillars=24000, max_points_per_pillar=32, pfn_features=64,
        enc_channels=(64, 128, 256), enc_blocks=(2, 2, 2),
        dec_channels=128, num_classes=20, ignore_index=0, dtype="bfloat16")
    return replace(cfg, **overrides)


def sst_kitti(**overrides):
    """KITTI car SST: the PointPillars KITTI grid (432x496, 0.16 m
    pillars) through a 4-block windowed transformer (8x8-cell windows, 64
    token slots each), single-stride detection at full resolution. Pass
    ``moe_experts=N`` for the Switch-MoE variant."""
    cfg = SSTConfig(
        bounds=(0.0, 69.12, -39.68, 39.68, -3.0, 1.0), grid=(432, 496),
        max_pillars=12000, max_points_per_pillar=32, pfn_features=128,
        window=8, capacity=64, depth=4, num_heads=4, neck_channels=128,
        num_classes=1, anchor_sizes=(_KITTI_CAR,), dtype="bfloat16")
    return replace(cfg, **overrides)
