"""Waymo Open Dataset object taxonomy (port of
``d3d_tpu.dataset.waymo.constants``; reference
d3d/dataset/waymo/loader.py:30-38)."""

from enum import Enum, auto

__all__ = ["WaymoObjectClass"]


class WaymoObjectClass(Enum):
    """Object categories of the Waymo Open Dataset."""

    Unknown = 0
    Vehicle = auto()
    Pedestrian = auto()
    Sign = auto()
    Cyclist = auto()
