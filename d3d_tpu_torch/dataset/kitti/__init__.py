"""The KITTI 3D object loader (port of ``d3d_tpu.dataset.kitti``: the class
taxonomies and :class:`KittiObjectLoader`)."""

from .utils import (KittiObjectClass, SemanticKittiClass,
                    SemanticKittiLearningClass)
from .object import KittiObjectLoader

__all__ = ["KittiObjectClass", "SemanticKittiClass",
           "SemanticKittiLearningClass", "KittiObjectLoader"]
