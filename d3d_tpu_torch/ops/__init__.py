# the kernels' torch.library ops register when their modules load (a loaded
# torch.export artifact needs them and nothing else of the port)
from . import (epilogue, geometry_cuda, nms_cuda, rulebook,  # noqa: F401
               sparse_conv_cuda, stage_maps)
from .geometry_soa import intersect_area, rbox_iou, rbox_iou_matrix
from .nms import nms2d, soft_nms2d
from .voxel import voxelize_dense_padded, voxelize_mean_fm

__all__ = ["intersect_area", "rbox_iou", "rbox_iou_matrix", "nms2d",
           "soft_nms2d", "voxelize_dense_padded", "voxelize_mean_fm"]
