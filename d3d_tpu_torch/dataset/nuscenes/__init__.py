"""The nuScenes loader and taxonomy (port of ``d3d_tpu.dataset.nuscenes``);
the converter is :mod:`d3d_tpu_torch.dataset.nuscenes.converter`."""

from .constants import (NuscenesDetectionClass, NuscenesObjectClass,
                        NuscenesSegmentationClass)
from .loader import NuscenesLoader

__all__ = ["NuscenesObjectClass", "NuscenesDetectionClass",
           "NuscenesSegmentationClass", "NuscenesLoader"]
