"""The KITTI loaders (port of ``d3d_tpu.dataset.kitti``): the class
taxonomies, :class:`KittiObjectLoader`, :class:`KittiTrackingLoader`,
:class:`KittiOdometryLoader` (SemanticKITTI labels) and
:class:`KittiRawLoader`."""

from .utils import (KittiObjectClass, SemanticKittiClass,
                    SemanticKittiLearningClass)
from .object import KittiObjectLoader
from .tracking import KittiTrackingLoader
from .odometry import KittiOdometryLoader
from .raw import KittiRawLoader

__all__ = ["KittiObjectClass", "SemanticKittiClass",
           "SemanticKittiLearningClass", "KittiObjectLoader",
           "KittiTrackingLoader", "KittiOdometryLoader", "KittiRawLoader"]
