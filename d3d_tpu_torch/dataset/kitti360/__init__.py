"""The KITTI-360 loader (port of ``d3d_tpu.dataset.kitti360``: the
taxonomy, its label tables and :class:`KITTI360Loader`)."""

from .utils import Kitti360Class, id2label, kittiId2label
from .loader import KITTI360Loader

__all__ = ["Kitti360Class", "id2label", "kittiId2label", "KITTI360Loader"]
